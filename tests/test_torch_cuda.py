"""Each hand-written kernel against its plain version on a CUDA card, at the
tolerances of tests/test_kernels.py, for the attention shapes of qwen3-14b
(GQA, hd 128) and zamba2-7b (MHA, hd 112), a sweep of head dims, group sizes,
lengths and windows over both attention kernels (bf16 runs the wgmma/TMA and
cp.async kernels, float32 the FMA kernels), and the SSD sweep. The backward
kernels (flash attention, rmsnorm) against their plain versions, at 2e-2
(bf16) and 1e-4 (float32) of max|grad|, and through ``kernels.ops``' autograd
Functions; the hybrid's short prompts on the card; serving's launches
unchanged under ``inference_mode``. Every test here
carries the ``cuda`` marker and skips without a card. The file imports no JAX,
so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention_cuda, decode_attention_plain
from repro_torch.kernels.flash_attention import (
    flash_attention_bwd_cuda,
    flash_attention_bwd_plain,
    flash_attention_cuda,
    flash_attention_lse_plain,
    flash_attention_plain,
)
from repro_torch.kernels.rmsnorm import rmsnorm_bwd_plain, rmsnorm_bwd_triton, rmsnorm_plain, \
    rmsnorm_triton
from repro_torch.kernels.ssd_scan import ssd_intra_chunk_plain

pytestmark = pytest.mark.cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SSD_TOLS = (2e-4, 2e-4, 1e-5)          # y, state, tot (tests/test_kernels.py:81-83)
# backward kernels, as a share of max|grad|: bf16 as tests/test_kernels.py:22;
# float32 looser than 2e-5, as dq is summed by float32 atomics in any order
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) with nvcc and triton")
    from repro_torch.device import resolve_device
    return resolve_device("cuda")                      # TF32 off


def _card_inputs(dev, shapes, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(dtype) for s in shapes]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_on_card(cuda_card, dtype):
    td = DTYPES[dtype]
    tol = TOL[dtype]
    x, s = _card_inputs(cuda_card, [(2, 33, 5120), (5120,)], td, 0)
    torch.testing.assert_close(ops.rmsnorm(x, s), rmsnorm_plain(x, s), atol=tol, rtol=tol)
    for H, K, hd in ((40, 8, 128), (32, 32, 112)):
        q, k, v = _card_inputs(cuda_card, [(2, 300, H, hd), (2, 300, K, hd), (2, 300, K, hd)],
                               td, 1)
        for window in (None, 64):
            torch.testing.assert_close(ops.flash_attention(q, k, v, window=window),
                                       flash_attention_plain(q, k, v, window=window),
                                       atol=tol, rtol=tol)
            kl = torch.tensor(200, dtype=torch.int32, device=cuda_card)
            torch.testing.assert_close(
                ops.decode_attention(q[:, :1].contiguous(), k, v, kv_len=kl, window=window),
                decode_attention_plain(q[:, :1], k, v, kv_len=kl, window=window),
                atol=tol, rtol=tol)


ATTN_SWEEP = pytest.mark.parametrize("hd", [64, 112, 128])
ATTN_G = pytest.mark.parametrize("G", [1, 5, 8])
ATTN_S = pytest.mark.parametrize("S", [1, 17, 64, 65, 300])
ATTN_WINDOW = pytest.mark.parametrize("window", [None, 64])
ATTN_DTYPE = pytest.mark.parametrize("dtype", ["float32", "bfloat16"])


@ATTN_DTYPE
@ATTN_WINDOW
@ATTN_S
@ATTN_G
@ATTN_SWEEP
def test_flash_kernel_sweep_on_card(cuda_card, hd, G, S, window, dtype):
    """Ragged q and kv tiles (S 17, 65, 300), one row, GQA and MHA, hd 112's
    padded boxes; 2 kv heads, so H = 2 G."""
    td, tol = DTYPES[dtype], TOL[dtype]
    q, k, v = _card_inputs(cuda_card, [(2, S, 2 * G, hd), (2, S, 2, hd), (2, S, 2, hd)], td, 5)
    torch.testing.assert_close(flash_attention_cuda(q, k, v, window=window),
                               flash_attention_plain(q, k, v, window=window),
                               atol=tol, rtol=tol)


@ATTN_DTYPE
@ATTN_WINDOW
@ATTN_S
@ATTN_G
@ATTN_SWEEP
def test_decode_kernel_sweep_on_card(cuda_card, hd, G, S, window, dtype):
    """kv_len = S in a cache of S + 7 rows (an unused ragged tail)."""
    td, tol = DTYPES[dtype], TOL[dtype]
    T = S + 7
    q, k, v = _card_inputs(cuda_card, [(2, 1, 2 * G, hd), (2, T, 2, hd), (2, T, 2, hd)], td, 6)
    kl = torch.tensor(S, dtype=torch.int32, device=cuda_card)
    torch.testing.assert_close(decode_attention_cuda(q, k, v, kv_len=kl, window=window),
                               decode_attention_plain(q, k, v, kv_len=kl, window=window),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("la_kind", ["small", "model", "mixed"])
@pytest.mark.parametrize("shape", [(2, 4, 32, 8, 16, 16), (1, 2, 64, 4, 64, 64),
                                   (1, 1, 128, 2, 32, 64), (2, 3, 128, 12, 64, 64),
                                   (1, 1, 16, 1, 8, 8), (1, 2, 40, 3, 4, 12),
                                   (2, 2, 128, 113, 64, 64), (1, 1, 128, 2, 64, 128)])
def test_ssd_kernel_matches_plain_on_card(cuda_card, shape, la_kind):
    """One mma tile (Q 16, N = P = 8); Q, N and P off the mma tile (40, 4,
    12); H off the head group (113); P 128 at Q 128, where two x tiles do not
    fit in shared memory and the kernel runs one slot of 8 warps.
    la = -|z| * 0.1 is held to the float32 plain version; la = -softplus(z),
    the model's range, where L reaches ~-100 over a chunk and the float32
    plain version is itself ~4e-4 off, and la = z * 0.05, with la > 0 in
    places (exp(L_t - L_s) > 1), to the plain version run in float64."""
    B, nc, Q, H, N, P = shape
    rng = np.random.default_rng(9)
    z = rng.standard_normal((B, nc, Q, H))
    la = {"small": -np.abs(z) * 0.1, "model": -np.logaddexp(0.0, z), "mixed": z * 0.05}[la_kind]
    C, Bm = rng.standard_normal((B, nc, Q, N)), rng.standard_normal((B, nc, Q, N))
    x = rng.standard_normal((B, nc, Q, H, P))
    args = [torch.from_numpy(a.astype(np.float32)).to(cuda_card) for a in (la, C, Bm, x)]
    want = ssd_intra_chunk_plain(*(a.double() if la_kind != "small" else a for a in args))
    for got, want, tol in zip(ops.ssd_intra_chunk(*args), want, SSD_TOLS):
        torch.testing.assert_close(got, want.float(), atol=tol, rtol=tol)


def _rel_err(got, want, scale=None) -> float:
    """max|got - want| over max|want| (or over ``scale`` where given)."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    denom = want.abs().max() if scale is None else scale
    return float((got - want).abs().max() / max(float(denom), 1e-30))


@ATTN_DTYPE
@ATTN_WINDOW
@pytest.mark.parametrize("S", [1, 17, 65, 300])
@pytest.mark.parametrize("G", [1, 3, 4])
@ATTN_SWEEP
def test_flash_bwd_kernel_sweep_on_card(cuda_card, hd, G, S, window, dtype):
    """The forward's lse against the plain log-sum-exp, and dq, dk, dv against
    the plain backward on the same o and lse; 2 kv heads, H = 2 G."""
    td = DTYPES[dtype]
    q, k, v, do = _card_inputs(cuda_card, [(2, S, 2 * G, hd), (2, S, 2, hd), (2, S, 2, hd),
                                           (2, S, 2 * G, hd)], td, 7)
    o, lse = flash_attention_cuda(q, k, v, window=window, return_lse=True)
    want_lse = flash_attention_lse_plain(q, k, window=window)
    assert _rel_err(lse, want_lse) < 1e-5        # float32 scores on both sides
    o = flash_attention_plain(q, k, v, window=window).contiguous()
    got = flash_attention_bwd_cuda(q, k, v, o, want_lse, do, window=window)
    want = flash_attention_bwd_plain(q, k, v, o, want_lse, do, window=window)
    # at S = 1 the one weight is 1 and dq = dk = 0 exactly (both sides give
    # rounding noise): those two are held to zero on the scale of max|dv|
    top = float(want[2].float().abs().max())
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == td and g.shape == w.shape
        scale = top if S == 1 else None
        assert _rel_err(g, w, scale) < GRAD_TOL[dtype], name


@ATTN_DTYPE
@pytest.mark.parametrize("d", [128, 3072, 5120])
def test_rmsnorm_bwd_kernel_on_card(cuda_card, d, dtype):
    """The qk-norm width and the phi4-mini and qwen3-14b widths, a ragged row
    count; the forward's inv against the plain statistic."""
    td = DTYPES[dtype]
    x, s, g = _card_inputs(cuda_card, [(3, 37, d), (d,), (3, 37, d)], td, 8)
    y, inv = rmsnorm_triton(x, s, return_inv=True)
    torch.testing.assert_close(y, rmsnorm_plain(x, s), atol=TOL[dtype], rtol=TOL[dtype])
    want_inv = torch.rsqrt(x.float().square().mean(-1) + 1e-5)
    torch.testing.assert_close(inv, want_inv, atol=1e-6, rtol=1e-5)
    got = rmsnorm_bwd_triton(x, s, g, inv)
    want = rmsnorm_bwd_plain(x, s, g)
    for name, a, b in zip(("dx", "dscale"), got, want):
        assert a.dtype == b.dtype == td
        assert _rel_err(a, b) < GRAD_TOL[dtype], name


@ATTN_DTYPE
def test_ops_autograd_runs_backward_kernels(cuda_card, dtype):
    """Gradients through ``kernels.ops`` on the card (the autograd Functions)
    against autograd through the plain versions on the same values widened to
    float32, one launch each."""
    td = DTYPES[dtype]
    q, k, v, x, s = _card_inputs(cuda_card, [(2, 130, 6, 128), (2, 130, 2, 128),
                                             (2, 130, 2, 128), (2, 130, 3072), (3072,)], td, 9)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, x, s)]
    plain = [t.float().requires_grad_() for t in (q, k, v, x, s)]
    ops.reset_launches()
    out = ops.flash_attention(*leaves[:3], window=100).float().square().sum() + \
        ops.rmsnorm(leaves[3], leaves[4]).float().square().sum()
    out.backward()
    assert ops.LAUNCHES == {**dict.fromkeys(ops.KERNELS, 0), "flash_attention": 1,
                            "flash_attention_bwd": 1, "rmsnorm": 1, "rmsnorm_bwd": 1}
    ref = flash_attention_plain(*plain[:3], window=100).float().square().sum() + \
        rmsnorm_plain(plain[3], plain[4]).float().square().sum()
    ref.backward()
    for a, b in zip(leaves, plain):
        assert _rel_err(a.grad, b.grad) < GRAD_TOL[dtype]


def test_serving_launches_unchanged_under_inference_mode(cuda_card):
    """No gradient: the forward kernels alone, as the serving path runs them."""
    q, k, x, s = _card_inputs(cuda_card, [(1, 64, 4, 64), (1, 64, 2, 64), (2, 256), (256,)],
                              torch.bfloat16, 10)
    ops.reset_launches()
    with torch.inference_mode():
        ops.flash_attention(q.requires_grad_(), k, k)
        ops.rmsnorm(x, s.requires_grad_())
    with torch.no_grad():
        ops.flash_attention(q, k, k)
    assert ops.LAUNCHES == {**dict.fromkeys(ops.KERNELS, 0), "flash_attention": 2,
                            "rmsnorm": 1}


@pytest.mark.parametrize("prompt", [1, 2])
def test_hybrid_short_prompt_on_card(cuda_card, prompt):
    """The smoke zamba2-7b with head dim 64 (the kernels' smallest): a prompt
    shorter than the conv's W-1 rows, 3 decoded tokens, against the port's
    own full forward, within 2e-2 of max|logit| (tests/test_models.py:89)."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_smoke("zamba2-7b"), head_dim=64)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda_card).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, prompt + 3), device=cuda_card,
                         generator=torch.Generator(device=cuda_card).manual_seed(1))
    _, cache = model.prefill(params, {"tokens": toks[:, :prompt]}, prompt + 3)
    for i in range(3):
        logits, cache = model.decode_step(params, cache, {"token": toks[:, prompt + i]})
    full, _ = model.prefill(params, {"tokens": toks}, prompt + 3)
    assert _rel_err(logits, full) < 2e-2
