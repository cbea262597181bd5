"""The whole train step's share of the chip's bf16 peak: the model FLOPs of
every step in the window (the reference module's ``model_flops``, from the
configuration's shapes) over the window's time times 989 TFLOP/s."""

from portbench import peaks


def read(w):
    if not w.steps:
        return None
    flops = w.model_flops_per_step * w.steps
    return {"value": 100.0 * flops / (w.window_s * peaks.FLOPS_PER_S["bfloat16"]),
            "by": "operations"}
