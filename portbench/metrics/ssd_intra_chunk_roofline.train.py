"""ssd_intra_chunk's share of its roofline in the window: the least time its calls
could take (the larger of bytes over HBM bandwidth and operations over the
peak, from kernels/ssd_intra_chunk.py at each call's shape), summed, over the
kernel's device time."""

KERNEL = "ssd_intra_chunk"


def read(w):
    return w.roofline(KERNEL)
