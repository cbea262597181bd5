"""Device ms a step in PyTorch's own kernels: everything that is neither a
port kernel (``kernels/``) nor a cuBLAS/CUTLASS matmul nor a copy: AdamW,
the float32 loss, activations, RoPE, the casts."""


def read(w):
    if not w.steps or "torch_op" not in w.device_s:
        return None
    return {"value": 1e3 * w.device_s["torch_op"] / w.steps}
