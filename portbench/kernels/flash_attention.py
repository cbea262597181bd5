"""flash attention's forward (CUDA, ``csrc/flash_attention.cu``): its device
kernels' names and the work one call needs.

Frozen from ``chip_smoke.py``'s kernel table: q and o (H heads) and k and v
(K heads) moved once, each row's float32 log-sum-exp written where the
call returns it (training); 4·hd operations a valid (query, key) pair and
head (Q·Kᵀ and P·V), at the bf16 tensor-core peak, or outside the tensor
cores for float32 (the FMA kernel).
"""

TAP = ("repro_torch.kernels.ops", "flash_attention_cuda")
PATTERN = r"flash_fwd_kernel"


def pairs(S: int, T: int, causal: bool, window=None) -> int:
    """Valid (query row, key column) pairs: row r sees keys c <= r (causal),
    c > r - window (window), c < T."""
    if not causal:
        return S * T
    m = min(window or T, T)
    if S <= T:
        if S <= m:
            return S * (S + 1) // 2
        return m * (m + 1) // 2 + (S - m) * m
    w = window or S + T
    return sum(max(0, min(r, T - 1) - max(0, r - w + 1) + 1) for r in range(S))


def rate(t) -> str:
    return "float32" if t.element_size() == 4 else "bfloat16"


def work(q, k, v, *args, causal=True, window=None, return_lse=False, **kwargs):
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    nbytes = (2 * B * S * H * hd + 2 * B * T * K * hd) * q.element_size() \
        + 4 * B * H * S * bool(return_lse)
    return nbytes, {rate(q): 4 * B * H * hd * pairs(S, T, causal, window)}
