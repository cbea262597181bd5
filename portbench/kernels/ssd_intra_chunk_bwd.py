"""The SSD intra-chunk block's backward (CUDA, ``csrc/ssd_intra_chunk_bwd.cu``):
the head kernel and the one that forms dC and dB, and the work one call
needs.

Frozen from ``chip_smoke.py``'s kernel table, with C and B in G groups: la,
C, B, x, dy, dstate and dtot read once, dla, dC, dB and dx written once, all
float32. Products in 3xTF32 as the forward's: C . B^T, dC and dB from dCB
once a (chunk, group) on s <= t, and a head's dM = dy x^T and M^T dy on
s <= t, B dstate^T and x dstate; outside them a head's M, dCB and G on
s <= t.
"""

from .ssd_intra_chunk import dims

TAP = ("repro_torch.kernels.ops", "ssd_intra_chunk_bwd_cuda")
PATTERN = r"ssd_bwd_heads|ssd_bwd_cb"


def work(la, C, B_in, x, dy, dstates, dtot, *args, **kwargs):
    BC, Q, H, G, N, P = dims(la, C, x)
    tri = Q * (Q + 1) // 2
    nbytes = 4 * (2 * BC * Q * H + 4 * BC * Q * G * N + 3 * BC * Q * H * P + BC * H * P * N
                  + BC * H)
    return nbytes, {"tf32": 3 * (6 * BC * G * N * tri + BC * H * (4 * P * tri + 4 * Q * P * N)),
                    "float32": BC * H * (6 * tri + 4 * Q * N)}
