"""flash attention's backward (CUDA, ``csrc/flash_attention_bwd.cu``): the
prep kernel (D = rowsum(dO·O)), the main kernel and dq's cast, and the work
one call needs.

Frozen from ``chip_smoke.py``'s kernel table: q, o, dO and dq (H heads), k,
v, dk and dv (K heads) moved once, the float32 lse read; 2.5 times the
forward's operations (S, dP, dV, dK, dQ: 10·hd a valid pair and head).
"""

from .flash_attention import pairs, rate

TAP = ("repro_torch.kernels.ops", "flash_attention_bwd_cuda")
PATTERN = r"flash_bwd_kernel|bwd_prep_kernel|cast_kernel"


def work(q, k, v, out, lse, dout, *args, causal=True, window=None, **kwargs):
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    nbytes = (4 * B * S * H * hd + 4 * B * T * K * hd) * q.element_size() + 4 * B * H * S
    return nbytes, {rate(q): 10 * B * H * hd * pairs(S, T, causal, window)}
