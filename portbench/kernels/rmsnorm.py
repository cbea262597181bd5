"""rmsnorm's forward (Triton, ``kernels/rmsnorm.py``): its device kernels'
names and the work one call needs, from the shapes of its arguments.

Frozen from ``chip_smoke.py``'s kernel table: x read and y written once,
the scale read once; with ``return_inv`` (training) each row's float32
inverse rms written too. 4 operations an element, outside the tensor cores.
"""

TAP = ("repro_torch.kernels.ops", "rmsnorm_triton")
PATTERN = r"rmsnorm_kernel"


def work(x, scale, *args, return_inv=False, **kwargs):
    """(bytes, {rate: operations}) of ``rmsnorm_triton(x, scale, ...)``."""
    n, d = x.numel(), x.shape[-1]
    nbytes = 2 * n * x.element_size() + d * scale.element_size() + 4 * (n // d) * bool(return_inv)
    return nbytes, {"float32": 4 * n}
