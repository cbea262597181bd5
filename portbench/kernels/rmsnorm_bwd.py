"""rmsnorm's backward (Triton, ``kernels/rmsnorm.py``): the row kernel and
the column sum of dscale, and the work one call needs.

Frozen from ``chip_smoke.py``'s kernel table: x and g read, dx written,
each row's inv read; the scale read and dscale written. 8 operations an
element, outside the tensor cores.
"""

TAP = ("repro_torch.kernels.ops", "rmsnorm_bwd_triton")
PATTERN = r"rmsnorm_bwd_kernel|colsum_kernel"


def work(x, scale, g, inv, *args, **kwargs):
    n, d = x.numel(), x.shape[-1]
    nbytes = 3 * n * x.element_size() + 4 * (n // d) + 2 * d * scale.element_size()
    return nbytes, {"float32": 8 * n}
