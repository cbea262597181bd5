"""flash_attention's share of its roofline in the window: the least time its calls
could take (the larger of bytes over HBM bandwidth and operations over the
peak, from kernels/flash_attention.py at each call's shape), summed, over the
kernel's device time."""

KERNEL = "flash_attention"


def read(w):
    return w.roofline(KERNEL)
