"""The SSD intra-chunk block's forward (CUDA, ``csrc/ssd_intra_chunk.cu``):
its device kernel's name and the work one call needs.

Frozen from ``chip_smoke.py``'s kernel table, with C and B in G groups
(B, nc, Q, G, N), G = 1 where they are (B, nc, Q, N): la, C, B and x read
once, y, the states and tot written once, all float32. On the tensor cores
in 3xTF32 (three TF32 products for each float32 one, at the TF32 peak):
C . B^T once a (chunk, group) on s <= t, and a head's M . x on s <= t and
its state (w x)^T B. Outside them, a head's M on s <= t (difference, exp,
product), the end weights and w x.
"""

TAP = ("repro_torch.kernels.ops", "ssd_intra_chunk_cuda")
PATTERN = r"ssd_intra_chunk_kernel"


def dims(la, C, x) -> tuple:
    """(B * nc, Q, H, G, N, P) of a call."""
    Bs, nc, Q, H = la.shape
    G = C.shape[3] if C.dim() == 5 else 1
    return Bs * nc, Q, H, G, C.shape[-1], x.shape[-1]


def work(la, C, B_in, x, *args, **kwargs):
    BC, Q, H, G, N, P = dims(la, C, x)
    tri = Q * (Q + 1) // 2
    nbytes = 4 * (BC * Q * H + 2 * BC * Q * G * N + 2 * BC * Q * H * P + BC * H * P * N + BC * H)
    return nbytes, {"tf32": 3 * (2 * BC * G * N * tri + BC * H * (2 * P * tri + 2 * Q * P * N)),
                    "float32": BC * H * (3 * tri + 2 * Q + Q * P)}
