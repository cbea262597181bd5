"""Device ms a step of the optimizer: kernels launched in the program's
``step.optimizer`` span (AdamW over the float32 masters); with their count a
step (``launches``), the span's host ms a step (``host_ms``) and the device
ms a step of its ``optim.clip`` span, the global norm and the clip scale
(``clip_ms``). From the window's phase split (``phases.py``); None where it
has none."""

PHASE = "optimizer"


def read(w):
    phases = getattr(w, "phases", None)
    return phases.read(PHASE) if phases is not None else None
