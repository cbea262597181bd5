"""Each hand-written kernel against its plain version on a CUDA card, at the
tolerances of tests/test_kernels.py, for the attention shapes of qwen3-14b
(GQA, hd 128) and zamba2-7b (MHA, hd 112), a sweep of head dims, group sizes,
lengths and windows over both attention kernels (bf16 runs the wgmma/TMA and
cp.async kernels, float32 the FMA kernels), and the SSD sweep. The backward
kernels (flash attention, rmsnorm) against their plain versions, at 2e-2
(bf16) and 1e-4 (float32) of max|grad|, with the flash backward's tile
edges (128-key tiles, the 2-stage ring, hd 112's padding, a one-row grid)
and two calls held to each other, and through ``kernels.ops``' autograd
Functions; the hybrid's short prompts on the card; serving's launches
unchanged under ``inference_mode``; the kernels at the qwen3-moe-30b-a3b
and granite-moe-1b-a400m shapes, one MoE layer at the published widths
against the CPU with the routing shared, and the same layer under
``torch.cuda.set_sync_debug_mode("error")``; head dim 256 (gemma3-12b) in
the forward, decode and backward kernels, and one gemma3 block and the
smoke internvl2 on the card against the CPU; the SSD intra-chunk backward
kernel against its plain version in float64, alone and through
``ops.ssd_intra_chunk``'s autograd Function; rmsnorm's backward at the
gemma3 and zamba2 training shapes, one launch and two; one gemma3 block and
one zamba2 group training on the card against the CPU; Whisper's attention
cases (non-causal, S queries against T keys, T 1500) in the flash forward,
lse and backward and the decode kernel, and the smoke xLSTM and Whisper
serving and training on the card against the CPU; the decode kernel's lse
output at the qwen3-14b and gemma3 global decode shapes and kv_len 0; the
elastic restart (mirrored checkpoints, a storage node lost, the restore bit
for bit) on the smoke phi4-mini and whisper; the program's spans holding the
launches made inside them on the profiler's clock; the fused AdamW
(``kernels/adamw.py``) against its plain version bit for bit and through
``optim.update`` against the plain loop over several steps, one launch of
each kernel a leaf, no host sync, and the clip's norm repeating bit for bit;
Zamba2-7B's head dim 224 with its (hd/2)^-1/2 scale passed to the flash
forward and backward, the default scale's bits, the grouped SSD forward and
backward against float64, and the
smoke Zamba2 trained on the card against the CPU (two conv launches and one
conv backward a layer); the causal conv's forward and backward kernels
against float64 at Zamba2-7B's and xlstm-1.3b's training slices, ragged
lengths and narrower convs, the backward repeating bit for bit, and through
``ops.causal_conv_silu``'s autograd Function.
Every test here
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
from repro_torch.kernels.ssd_scan import (
    ssd_intra_chunk_bwd_cuda,
    ssd_intra_chunk_bwd_plain,
    ssd_intra_chunk_plain,
)

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
    C, Bm = rng.standard_normal((B, nc, Q, 1, N)), rng.standard_normal((B, nc, Q, 1, N))
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


def _bwd_case(dev, B, S, G, K, hd, window, dtype, seed=7):
    """Inputs, the forward's o and the plain lse for one backward case."""
    q, k, v, do = _card_inputs(dev, [(B, S, K * G, hd), (B, S, K, hd), (B, S, K, hd),
                                     (B, S, K * G, hd)], dtype, seed)
    lse = flash_attention_lse_plain(q, k, window=window)
    o = flash_attention_plain(q, k, v, window=window).contiguous()
    return q, k, v, o, lse, do


@ATTN_DTYPE
@pytest.mark.parametrize("B,S,G,K,hd,window", [
    (2, 127, 1, 2, 128, None),      # one kv tile of 128 keys, its last key ragged
    (2, 129, 3, 2, 128, None),      # a second kv tile holding one key
    (2, 257, 4, 2, 128, None),      # 5 q tiles: the 2-stage ring wraps an odd number of times
    (2, 257, 3, 2, 128, 64),        # a window shorter than a 128-key tile
    (2, 200, 3, 2, 112, None),      # S off the 64-row q tile at G 3, hd 112's padded columns
    (2, 200, 3, 2, 112, 64),
    (1, 300, 3, 1, 128, None),      # B K = 1: the grid is one row of kv tiles
    (1, 129, 2, 1, 64, 64),         # hd 64 (64-key tiles, one consumer warpgroup)
])
def test_flash_bwd_kernel_tile_edges_on_card(cuda_card, B, S, G, K, hd, window, dtype):
    """The edges that 128-key kv tiles, a 2-stage (Q, dO) ring and dQ added
    by 64 x 32 bulk reductions create, against the plain backward."""
    td = DTYPES[dtype]
    q, k, v, o, lse, do = _bwd_case(cuda_card, B, S, G, K, hd, window, td)
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, window=window)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == td and g.shape == w.shape
        assert _rel_err(g, w) < GRAD_TOL[dtype], name


@ATTN_DTYPE
@pytest.mark.parametrize("B,S,T,G,K,hd,causal,window", [
    (2, 600, 600, 3, 2, 128, True, None),
    (2, 600, 600, 2, 2, 64, True, 128),      # 64-key tiles, a window
    (2, 300, 300, 2, 2, 256, True, None),    # hd 256: two warpgroups on the same keys
    (4, 448, 1500, 1, 6, 64, False, None),   # whisper's cross-attention: 24 kv tiles a q tile
])
def test_flash_bwd_kernel_repeats_within_tolerance(cuda_card, B, S, T, G, K, hd, causal, window,
                                                   dtype):
    """Five calls on the same inputs give the same dq, dk and dv bit for bit:
    dk and dv are summed in registers, dq's additions take the order of
    their kv tiles; and dq is within the stated tolerance of the plain
    backward's."""
    td = DTYPES[dtype]
    q, k, v, do = _card_inputs(cuda_card, [(B, S, K * G, hd), (B, T, K, hd), (B, T, K, hd),
                                           (B, S, K * G, hd)], td, 11)
    o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window, return_lse=True)
    first = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal, window=window)
    for _ in range(4):
        again = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal, window=window)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, window=window)
    assert _rel_err(first[0], want[0]) < GRAD_TOL[dtype]


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


# -- MoE: the kernels at the MoE models' shapes, one MoE layer on the card ------------
@ATTN_DTYPE
@pytest.mark.parametrize("case", ["flash qwen3-moe prefill", "decode qwen3-moe",
                                  "flash_bwd granite train", "rmsnorm qwen3-moe",
                                  "rmsnorm_bwd granite train"])
def test_kernels_at_moe_model_shapes_on_card(cuda_card, case, dtype):
    """qwen3-moe-30b-a3b serving (32 query heads over 4 kv heads, G 8, hd 128;
    d 2048) and granite-moe-1b-a400m training (16 over 8, G 2, hd 64; d 1024)."""
    td, tol = DTYPES[dtype], TOL[dtype]
    if case == "flash qwen3-moe prefill":
        q, k, v = _card_inputs(cuda_card, [(8, 512, 32, 128), (8, 512, 4, 128),
                                           (8, 512, 4, 128)], td, 12)
        torch.testing.assert_close(flash_attention_cuda(q, k, v), flash_attention_plain(q, k, v),
                                   atol=tol, rtol=tol)
    elif case == "decode qwen3-moe":
        q, k, v = _card_inputs(cuda_card, [(8, 1, 32, 128), (8, 544, 4, 128),
                                           (8, 544, 4, 128)], td, 13)
        kl = torch.tensor(528, dtype=torch.int32, device=cuda_card)
        torch.testing.assert_close(decode_attention_cuda(q, k, v, kv_len=kl),
                                   decode_attention_plain(q, k, v, kv_len=kl),
                                   atol=tol, rtol=tol)
    elif case == "flash_bwd granite train":
        q, k, v, o, lse, do = _bwd_case(cuda_card, 4, 2048, 2, 8, 64, None, td, seed=14)
        _, got_lse = flash_attention_cuda(q, k, v, return_lse=True)
        assert _rel_err(got_lse, lse) < 1e-5
        got = flash_attention_bwd_cuda(q, k, v, o, lse, do)
        want = flash_attention_bwd_plain(q, k, v, o, lse, do)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert _rel_err(g, w) < GRAD_TOL[dtype], name
    elif case == "rmsnorm qwen3-moe":
        x, s = _card_inputs(cuda_card, [(8 * 512, 2048), (2048,)], td, 15)
        torch.testing.assert_close(rmsnorm_triton(x, s), rmsnorm_plain(x, s), atol=tol, rtol=tol)
    else:
        x, s, g = _card_inputs(cuda_card, [(4 * 2048, 1024), (1024,), (4 * 2048, 1024)], td, 16)
        _, inv = rmsnorm_triton(x, s, return_inv=True)
        for name, a, b in zip(("dx", "dscale"), rmsnorm_bwd_triton(x, s, g, inv),
                              rmsnorm_bwd_plain(x, s, g)):
            assert _rel_err(a, b) < GRAD_TOL[dtype], name


MOE_ARCHS = pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "granite-moe-1b-a400m"])


def _moe_layer(dev, arch, dtype, S, seed=0):
    """One MoE FFN at the published widths: params and an input (2, S, d)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config(arch), dtype="float32" if dtype == torch.float32
                              else "bfloat16")
    p = moe.moe_init(torch.Generator(device=dev).manual_seed(seed), cfg, dtype=dtype)
    x, = _card_inputs(dev, [(2, S, cfg.d_model)], dtype, seed + 1)
    return cfg, p, x


@MOE_ARCHS
def test_moe_layer_matches_cpu_with_shared_routing(cuda_card, arch):
    """float32, B 2, S 64: the router logits on the card within 1e-5 of
    max|logit| of the CPU's on the same input; then the dispatch, expert
    products and combine fed the card's (w, idx) on both sides, y within
    1e-4 of max|y|, and the aux within 1e-5. The routing is shared because
    two correct top-k's may differ where two probabilities are within
    rounding of each other."""
    from repro_torch.models import moe
    from repro_torch.models.common import tree_map
    cfg, p, x = _moe_layer(cuda_card, arch, torch.float32, 64)
    pc, xc = tree_map(lambda t: t.cpu(), p), x.cpu()
    logits, probs, w, idx = moe.route(p, x, cfg)
    y = moe.experts(p, x, w, idx, cfg)
    y_cpu = moe.experts(pc, xc, w.cpu(), idx.cpu(), cfg)
    assert _rel_err(logits.cpu(), moe.route(pc, xc, cfg)[0]) < 1e-5
    assert _rel_err(y.cpu(), y_cpu) < 1e-4
    aux = moe.load_balance_aux(probs, idx, cfg.n_experts)
    aux_cpu = moe.load_balance_aux(probs.cpu(), idx.cpu(), cfg.n_experts)
    assert float(aux) == pytest.approx(float(aux_cpu), rel=1e-5)


@MOE_ARCHS
def test_moe_layer_runs_without_host_sync(cuda_card, arch):
    """One bf16 MoE FFN at the published widths, forward and backward at a
    prefill shape and forward at a decode shape (S 1), under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing in the routing or
    the dispatch reads a value back to the host."""
    from repro_torch.models import moe
    cfg, p, x = _moe_layer(cuda_card, arch, torch.bfloat16, 128)
    for t in (p["router"]["w"], p["gate"], p["up"], p["down"]):
        t.requires_grad_(True)
    x.requires_grad_(True)

    def run():
        y, aux = moe.moe_ffn(p, x, cfg)
        (y.float().square().mean() + aux).backward()
        with torch.no_grad():
            return moe.moe_ffn(p, x[:, :1], cfg)[0]
    run()                                               # first calls set up handles
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(out.float()).all() and torch.isfinite(x.grad.float()).all()


# -- head dim 256 (gemma3-12b): forward and decode kernels only ----------------
@ATTN_DTYPE
@pytest.mark.parametrize("B,S,G,K,window", [
    (2, 1, 1, 1, None), (2, 17, 2, 2, None), (2, 65, 2, 2, 64), (2, 300, 2, 8, None),
    (2, 1000, 2, 8, 100), (1, 1536, 2, 8, 1024), (2, 129, 1, 8, None), (1, 300, 5, 2, 64)])
def test_flash_kernel_hd256_on_card(cuda_card, B, S, G, K, window, dtype):
    """hd 256 tiles (four boxes a row, P.V as two N = 128 halves): one row,
    ragged q/kv tiles, G 1, 2 (gemma3) and 5, gemma3's window of 1024 over a
    1536-token prompt, a window shorter than a tile."""
    td, tol = DTYPES[dtype], TOL[dtype]
    q, k, v = _card_inputs(cuda_card, [(B, S, G * K, 256), (B, S, K, 256), (B, S, K, 256)],
                           td, 11)
    torch.testing.assert_close(flash_attention_cuda(q, k, v, window=window),
                               flash_attention_plain(q, k, v, window=window),
                               atol=tol, rtol=tol)


@ATTN_DTYPE
@pytest.mark.parametrize("T,kv_len,G", [(1024, 1024, 2), (1024, 300, 2), (1024, 1, 2),
                                        (1568, 1537, 2), (100, 37, 1), (544, 17, 5)])
def test_decode_kernel_hd256_on_card(cuda_card, T, kv_len, G, dtype):
    """hd 256 rows a whole warp wide, 16-row ring tiles: gemma3's local ring
    (W = 1024) partly filled and full, its global cache, short caches."""
    td, tol = DTYPES[dtype], TOL[dtype]
    q, k, v = _card_inputs(cuda_card, [(8, 1, 8 * G, 256), (8, T, 8, 256), (8, T, 8, 256)],
                           td, 12)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=cuda_card)
    torch.testing.assert_close(decode_attention_cuda(q, k, v, kv_len=kl),
                               decode_attention_plain(q, k, v, kv_len=kl),
                               atol=tol, rtol=tol)


@ATTN_DTYPE
def test_flash_backward_launches_hd256(cuda_card, dtype):
    """Under autograd at hd 256 the forward and backward kernels launch,
    once each, and the gradients agree with autograd through the plain
    version on the same values widened to float32; without a gradient the
    forward alone runs."""
    td = DTYPES[dtype]
    q, k, v = _card_inputs(cuda_card, [(1, 96, 4, 256), (1, 96, 2, 256), (1, 96, 2, 256)], td, 13)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    plain = [t.float().requires_grad_() for t in (q, k, v)]
    ops.reset_launches()
    ops.flash_attention(*leaves, window=40).float().square().sum().backward()
    assert ops.LAUNCHES == {**dict.fromkeys(ops.KERNELS, 0), "flash_attention": 1,
                            "flash_attention_bwd": 1}
    flash_attention_plain(*plain, window=40).float().square().sum().backward()
    for a, b in zip(leaves, plain):
        assert _rel_err(a.grad, b.grad) < GRAD_TOL[dtype]
    with torch.no_grad():
        ops.flash_attention(q, k, v)
    assert ops.LAUNCHES["flash_attention"] == 2 and ops.LAUNCHES["flash_attention_bwd"] == 1


@ATTN_DTYPE
@pytest.mark.parametrize("B,S,G,K,window", [
    (2, 1, 1, 1, None), (2, 17, 2, 2, None), (2, 65, 2, 2, 64), (2, 130, 2, 2, None),
    (2, 300, 2, 8, 100), (1, 129, 5, 2, 64), (4, 2048, 2, 8, None), (4, 2048, 2, 8, 1024)])
def test_flash_bwd_kernel_hd256_on_card(cuda_card, B, S, G, K, window, dtype):
    """hd 256: in bf16 two warpgroups on the same 64 keys, each with half of
    dK's and dV's columns, over a one-stage (Q, dO) ring; in float32 32-row
    q tiles. One row, ragged tiles, a kv tile of one key, G 5, and gemma3's
    training shape (B 4, S 2048, 16 q and 8 kv heads), causal and with its
    1024 window. dq is held on the scale of max|dv| at S = 1, where it is
    zero."""
    td = DTYPES[dtype]
    q, k, v, o, lse, do = _bwd_case(cuda_card, B, S, G, K, 256, window, td, seed=14)
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, window=window)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, window=window)
    top = float(want[2].float().abs().max())
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == td and g.shape == w.shape
        assert _rel_err(g, w, top if S == 1 else None) < GRAD_TOL[dtype], name


# -- the SSD intra-chunk backward ---------------------------------------------
def _ssd_bwd_inputs(dev, shape, la_kind, seed=15, G=1):
    """la, C, B, x and the output gradients dy, dstates, dtot, float32 on
    ``dev``; C and B in G groups."""
    B, nc, Q, H, N, P = shape
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, nc, Q, H))
    la = {"small": -np.abs(z) * 0.1, "model": -np.logaddexp(0.0, z), "mixed": z * 0.05}[la_kind]
    shapes = ((B, nc, Q, G, N), (B, nc, Q, G, N), (B, nc, Q, H, P), (B, nc, Q, H, P),
              (B, nc, H, P, N), (B, nc, H))
    return [torch.from_numpy(a.astype(np.float32)).to(dev)
            for a in (la, *(rng.standard_normal(s) for s in shapes))]


@pytest.mark.parametrize("la_kind", ["small", "model", "mixed"])
@pytest.mark.parametrize("shape", [(2, 4, 32, 8, 16, 16), (1, 2, 64, 4, 64, 64),
                                   (1, 1, 16, 1, 8, 8), (1, 2, 40, 3, 4, 12),
                                   (2, 2, 128, 113, 64, 64), (1, 1, 128, 2, 64, 128),
                                   (1, 2, 24, 5, 64, 200), (4, 16, 128, 112, 64, 64),
                                   (2, 2, 17, 3, 16, 20)])
def test_ssd_bwd_kernel_matches_float64_on_card(cuda_card, shape, la_kind):
    """dla, dC, dB and dx against autograd through the plain forward in
    float64, each within 1e-4 of its max: one 16-row chunk; Q, N and P off
    any tile (40, 4, 12); H 113 over the head groups; P 128 and 200 in passes
    of 64 columns; zamba2-7b's training shape (B 4, 16 chunks, H 112); Q 17,
    a full 16-row strip and a strip of one row, so that the diagonal's edge
    falls inside a tile; la in the model's range (L to ~-100 over a chunk)
    and with la > 0 in places."""
    args = _ssd_bwd_inputs(cuda_card, shape, la_kind)
    got = ssd_intra_chunk_bwd_cuda(*args)
    want = ssd_intra_chunk_bwd_plain(*(a.double() for a in args))
    for name, g, w in zip(("dla", "dC", "dB", "dx"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _rel_err(g.double(), w) < GRAD_TOL["float32"], name


@pytest.mark.parametrize("shape,plans", [((2, 2, 128, 113, 64, 64), (57, 5)),
                                         ((1, 3, 96, 9, 32, 136), (9, 2))])
def test_ssd_bwd_head_groups_agree_on_card(cuda_card, shape, plans):
    """Two head-group plans on the same inputs (one group of 57 heads and
    the rest against groups of 5; P 136 in three passes) agree within 1e-6
    of each output's max|grad|: a plan moves only the order in which the
    groups' dCB and dB partials are summed."""
    args = _ssd_bwd_inputs(cuda_card, shape, "model", seed=17)
    got = [ssd_intra_chunk_bwd_cuda(*args, heads_per_group=hg) for hg in plans]
    for name, a, b in zip(("dla", "dC", "dB", "dx"), *got):
        assert _rel_err(a.double(), b.double()) < 1e-6, name


def test_ops_ssd_intra_chunk_autograd_on_card(cuda_card):
    """The gradient of a scalar function of y and the states through
    ``ops.ssd_intra_chunk`` on the card (its autograd Function: the forward
    and backward kernels, one launch each) against the float64 plain
    version's, within 1e-4 of each max|grad|; tot unused, as in the model.
    Without the Function the kernel's outputs carry no gradient at all."""
    la, C, Bm, x, dy, dst, _ = _ssd_bwd_inputs(cuda_card, (2, 3, 64, 6, 16, 32), "model")
    ins = [t.clone().requires_grad_() for t in (la, C, Bm, x)]
    ops.reset_launches()
    y, st, _ = ops.ssd_intra_chunk(*ins)
    ((y * dy).sum() + (st * dst).sum()).backward()
    assert ops.LAUNCHES == {**dict.fromkeys(ops.KERNELS, 0), "ssd_intra_chunk": 1,
                            "ssd_intra_chunk_bwd": 1}
    ref = [t.double().requires_grad_() for t in (la, C, Bm, x)]
    ry, rst, _ = ssd_intra_chunk_plain(*ref)
    ((ry * dy.double()).sum() + (rst * dst.double()).sum()).backward()
    for name, a, b in zip(("dla", "dC", "dB", "dx"), ins, ref):
        assert a.grad is not None, name
        assert _rel_err(a.grad.double(), b.grad) < GRAD_TOL["float32"], name


@ATTN_DTYPE
@pytest.mark.parametrize("rows,d", [(8192, 1024), (8192, 3840), (131072, 256), (65536, 256),
                                    (8192, 3584), (37, 3840)])
def test_rmsnorm_bwd_training_shapes_on_card(cuda_card, rows, d, dtype):
    """granite's, gemma3's (layer norms, q-norm, k-norm) and zamba2's
    training shapes, and a ragged few rows, with ``bwd_plan``'s programs."""
    td = DTYPES[dtype]
    x, s, g = _card_inputs(cuda_card, [(rows, d), (d,), (rows, d)], td, 16)
    _, inv = rmsnorm_triton(x, s, return_inv=True)
    got = rmsnorm_bwd_triton(x, s, g, inv)
    want = rmsnorm_bwd_plain(x, s, g)
    for name, a, b in zip(("dx", "dscale"), got, want):
        assert a.dtype == b.dtype == td
        assert _rel_err(a, b) < GRAD_TOL[dtype], name


@pytest.mark.parametrize("arch", ["gemma3-12b", "zamba2-7b"])
def test_training_block_on_card_matches_cpu(cuda_card, arch):
    """One gemma3 block (2 local layers, window 32, and a global one) at head
    dim 256 and one zamba2 group (2 mamba layers and the shared block) at
    head dim 64, float32, S 48 (longer than gemma3's window; two SSD chunks
    of 32, the second padded): loss and every grad leaf of the card's kernel
    path (remat "full") against the CPU plain path, 1e-4 and 1e-4 of
    max|g|; every backward kernel of the block launched."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.optim.adamw import leaves
    from repro_torch.runtime import loss_and_grads
    cfg = get_smoke(arch)
    cfg = dataclasses.replace(cfg, head_dim=256, n_layers=3) if cfg.local_global_ratio else \
        dataclasses.replace(cfg, head_dim=64, n_layers=2)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda_card).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 49), device=cuda_card,
                         generator=torch.Generator(device=cuda_card).manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    ops.reset_launches()
    loss, _, grads = loss_and_grads(model, params, batch, remat="full")
    bwd = ["rmsnorm_bwd", "flash_attention_bwd"] + (["ssd_intra_chunk_bwd"]
                                                    if cfg.family == "hybrid" else [])
    assert all(ops.LAUNCHES[k] > 0 for k in bwd), ops.LAUNCHES
    cpu = tree_map(lambda t: t.detach().cpu(), params)
    host_loss, _, host_grads = loss_and_grads(model, cpu, {k: v.cpu() for k, v in batch.items()},
                                              remat="full")
    assert abs(float(loss) - float(host_loss)) < 1e-4
    for a, b in zip(leaves(grads), leaves(host_grads)):
        assert _rel_err(a.cpu(), b) < 1e-4


@pytest.mark.parametrize("arch,prompt", [("gemma3-12b", 40), ("internvl2-2b", 24)])
def test_local_global_and_vlm_on_card_match_cpu(cuda_card, arch, prompt):
    """One gemma3 block (2 local layers, window 32, and a global one) at head
    dim 256 and the smoke internvl2 with its patch prefix at head dim 128,
    float32: the card's kernels against the CPU's plain path on the same
    weights, prefill and 4 decode steps (gemma3's 40-token prompt wraps the
    ring), 1e-4 of max|logit| and equal greedy tokens. Every attention call
    on the card went through a kernel."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.launch.serve import generate, make_patch_embeds
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    cfg = get_smoke(arch)
    cfg = dataclasses.replace(cfg, head_dim=256, n_layers=3) if cfg.local_global_ratio else \
        dataclasses.replace(cfg, head_dim=128)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda_card).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, prompt), device=cuda_card,
                         generator=torch.Generator(device=cuda_card).manual_seed(1))
    pe = make_patch_embeds(cfg, 2, cuda_card, 2) if cfg.family == "vlm" else None
    ops.reset_launches()
    card = generate(model, params, toks, 5, pe)
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    assert ops.LAUNCHES["decode_attention"] == 4 * cfg.n_layers
    host = generate(model, tree_map(lambda t: t.cpu(), params), toks.cpu(), 5,
                    None if pe is None else pe.cpu())
    assert _rel_err(card["last_logits"].cpu(), host["last_logits"]) < 1e-4
    assert torch.equal(card["tokens"].cpu(), host["tokens"])


# -- Whisper's attention cases and the xLSTM / Whisper models on the card ---------------
@ATTN_DTYPE
@pytest.mark.parametrize("S,T,H,K", [
    (1500, 1500, 6, 6),     # whisper-tiny's encoder: S = T = 1500, off every tile
    (416, 1500, 6, 6),      # its cross-attention when serving (prompt 416)
    (448, 1500, 6, 6),      # and when training (its 448-token text context)
    (1, 1500, 6, 6),        # one query row
    (17, 300, 6, 2),        # ragged S and T, GQA
    (300, 65, 4, 2),        # more queries than keys
    (129, 257, 6, 3),       # a second kv tile of one key, S and T ragged
])
def test_flash_noncausal_and_cross_lengths_on_card(cuda_card, S, T, H, K, dtype):
    """Non-causal flash attention with S queries against T keys at hd 64,
    forward, lse and backward, against the plain versions (the forward at
    2e-5 / 2e-2, the lse at 1e-5, the grads at 1e-4 / 2e-2 of max|grad|)."""
    td, tol = DTYPES[dtype], TOL[dtype]
    q, k, v, do = _card_inputs(cuda_card, [(2, S, H, 64), (2, T, K, 64), (2, T, K, 64),
                                           (2, S, H, 64)], td, 17)
    o, lse = flash_attention_cuda(q, k, v, causal=False, return_lse=True)
    torch.testing.assert_close(o, flash_attention_plain(q, k, v, causal=False),
                               atol=tol, rtol=tol)
    want_lse = flash_attention_lse_plain(q, k, causal=False)
    assert _rel_err(lse, want_lse) < 1e-5
    o = flash_attention_plain(q, k, v, causal=False).contiguous()
    got = flash_attention_bwd_cuda(q, k, v, o, want_lse, do, causal=False)
    want = flash_attention_bwd_plain(q, k, v, o, want_lse, do, causal=False)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == td and g.shape == w.shape
        assert _rel_err(g, w) < GRAD_TOL[dtype], name


@ATTN_DTYPE
def test_ops_autograd_noncausal_cross_on_card(cuda_card, dtype):
    """``ops.flash_attention(causal=False)`` under autograd with S != T: one
    forward and one backward launch, the grads against autograd through the
    plain version widened to float32."""
    td = DTYPES[dtype]
    q, k, v = _card_inputs(cuda_card, [(2, 448, 6, 64), (2, 1500, 6, 64), (2, 1500, 6, 64)],
                           td, 18)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    plain = [t.float().requires_grad_() for t in (q, k, v)]
    ops.reset_launches()
    ops.flash_attention(*leaves, causal=False).float().square().sum().backward()
    assert ops.LAUNCHES == {**dict.fromkeys(ops.KERNELS, 0), "flash_attention": 1,
                            "flash_attention_bwd": 1}
    flash_attention_plain(*plain, causal=False).float().square().sum().backward()
    for a, b in zip(leaves, plain):
        assert _rel_err(a.grad, b.grad) < GRAD_TOL[dtype]


@ATTN_DTYPE
@pytest.mark.parametrize("kv_len", [1500, 1499, 37])
def test_decode_kernel_whisper_cross_on_card(cuda_card, kv_len, dtype):
    """The decode kernel over whisper-tiny's 1500 encoder keys (B 8, 6 heads
    of 64): all of them, as the cross-attention reads them, and a prefix."""
    td, tol = DTYPES[dtype], TOL[dtype]
    q, k, v = _card_inputs(cuda_card, [(8, 1, 6, 64), (8, 1500, 6, 64), (8, 1500, 6, 64)],
                           td, 19)
    kl = torch.tensor(kv_len, dtype=torch.int32, device=cuda_card)
    torch.testing.assert_close(decode_attention_cuda(q, k, v, kv_len=kl),
                               decode_attention_plain(q, k, v, kv_len=kl), atol=tol, rtol=tol)


def _smoke64(arch):
    import dataclasses

    from repro_torch.configs import get_smoke
    return dataclasses.replace(get_smoke(arch), head_dim=64)


@pytest.mark.parametrize("arch,prompt", [("xlstm-1.3b", 40), ("xlstm-1.3b", 2),
                                         ("whisper-tiny", 24)])
def test_xlstm_and_whisper_serve_on_card_match_cpu(cuda_card, arch, prompt):
    """The smoke xLSTM (a prompt padding its second chunk, and one shorter
    than the conv's W-1 rows) and the smoke whisper with seeded frames, head
    dim 64, float32: prefill and 4 decode steps on the card against the
    CPU's plain path on the same weights, 1e-4 of max|logit| and equal
    greedy tokens; the launches each path implies."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    cfg = _smoke64(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda_card).manual_seed(0))
    g = torch.Generator(device=cuda_card).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, prompt), device=cuda_card, generator=g)
    kw = {}
    if cfg.family == "audio":
        kw["frames"] = 0.1 * torch.randn((2, cfg.encoder_seq, cfg.d_model), device=cuda_card,
                                         generator=g)
    ops.reset_launches()
    card = generate(model, params, toks, 5, **kw)
    L = cfg.n_layers
    if cfg.family == "audio":
        norms = (2 * cfg.encoder_layers + 1) + (3 * L + 1) * 5
        want = {"flash_attention": cfg.encoder_layers + 2 * L, "decode_attention": 2 * L * 4}
    else:
        nb = L // cfg.slstm_period
        norms = (3 * nb + 2 * nb * (cfg.slstm_period - 1) + 1) * 5
        want = {"causal_conv_silu": nb * (cfg.slstm_period - 1)}     # the prefill's mLSTMs
    assert ops.LAUNCHES == {**dict.fromkeys(ops.KERNELS, 0), "rmsnorm": norms, **want}
    host = generate(model, tree_map(lambda t: t.cpu(), params), toks.cpu(), 5,
                    **{k: v.cpu() for k, v in kw.items()})
    assert _rel_err(card["last_logits"].cpu(), host["last_logits"]) < 1e-4
    assert torch.equal(card["tokens"].cpu(), host["tokens"])


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "whisper-tiny"])
def test_xlstm_and_whisper_train_on_card_match_cpu(cuda_card, arch):
    """The smoke xLSTM and whisper (seeded frames) at head dim 64, float32,
    B 2, S 48 (two xLSTM chunks of 32, the second padded): loss and every
    grad leaf of the card's kernel path (remat "full") against the CPU
    plain path, 1e-4 and 1e-4 of max|g|; the backward kernels launched."""
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.optim.adamw import leaves
    from repro_torch.runtime import loss_and_grads
    cfg = _smoke64(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda_card).manual_seed(0))
    g = torch.Generator(device=cuda_card).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 49), device=cuda_card, generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "audio":
        batch["frames"] = 0.1 * torch.randn((2, cfg.encoder_seq, cfg.d_model),
                                            device=cuda_card, generator=g)
    ops.reset_launches()
    loss, _, grads = loss_and_grads(model, params, batch, remat="full")
    bwd = ["rmsnorm_bwd"] + (["flash_attention_bwd"] if cfg.family == "audio" else [])
    assert all(ops.LAUNCHES[k] > 0 for k in bwd), ops.LAUNCHES
    cpu = tree_map(lambda t: t.detach().cpu(), params)
    host_loss, _, host_grads = loss_and_grads(model, cpu, {k: v.cpu() for k, v in batch.items()},
                                              remat="full")
    assert abs(float(loss) - float(host_loss)) < 1e-4
    for a, b in zip(leaves(grads), leaves(host_grads)):
        assert _rel_err(a.cpu(), b) < 1e-4


@ATTN_DTYPE
@pytest.mark.parametrize("shape", [(8, 40, 8, 128, 544), (8, 16, 8, 256, 1568)],
                         ids=["qwen3-14b", "gemma3-global"])
@pytest.mark.parametrize("kv_len", ["full", 37, 0])
def test_decode_kernel_lse_on_card(cuda_card, shape, kv_len, dtype):
    """The decode kernel's per-row lse (written by its combine pass) against
    the plain version at qwen3-14b's and gemma3-12b's global decode shapes;
    kv_len 0 gives zeros and -inf, without NaN."""
    B, H, K, hd, T = shape
    n = T - 3 if kv_len == "full" else kv_len
    td, tol = DTYPES[dtype], TOL[dtype]
    q, k, v = _card_inputs(cuda_card, [(B, 1, H, hd), (B, T, K, hd), (B, T, K, hd)], td, 31)
    kl = torch.tensor(n, dtype=torch.int32, device=cuda_card)
    out, lse = decode_attention_cuda(q, k, v, kv_len=kl, return_lse=True)
    want_out, want_lse = decode_attention_plain(q, k, v, kv_len=kl, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    torch.testing.assert_close(out, want_out, atol=tol, rtol=tol)
    if n == 0:
        assert torch.isneginf(lse).all() and not torch.isnan(out).any()
        assert torch.equal(out, torch.zeros_like(out))
    else:
        torch.testing.assert_close(lse, want_lse, atol=tol, rtol=tol)
    # the output alone is unchanged by asking for the lse
    torch.testing.assert_close(decode_attention_cuda(q, k, v, kv_len=kl), out, atol=0, rtol=0)


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "whisper-tiny"])
def test_elastic_restart_on_card(cuda_card, arch):
    """``launch.elastic.elastic_restart`` on the smoke config at head dim 64:
    every restored leaf equals the live one bit for bit, on the card; step 7
    from the restored state and from a clone of the live state give one
    loss; the mirror kept serving after the node loss."""
    from repro_torch.launch.elastic import elastic_restart
    ops.reset_launches()
    res = elastic_restart(_smoke64(arch), device="cuda", log=lambda s: None)
    assert res["restored_mismatches"] == 0 and res["degraded"]
    assert res["live_loss"] == res["resumed_loss"] and np.isfinite(res["losses"]).all()
    assert ops.LAUNCHES["flash_attention_bwd"] > 0 and ops.LAUNCHES["rmsnorm_bwd"] > 0


def test_launches_land_inside_their_spans_on_the_profilers_clock(cuda_card):
    """Kernels launched inside two spans on the card, profiled with the CUDA
    activity alone (as the benchmark's traced window is): each kernel's
    correlation id finds its host-side launch (a ``cuda*`` or ``cu*`` API
    call), and each launch, put on the spans' clock by the recording's
    offsets, lies inside the span that launched it, not the other."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import spans
    x = torch.randn(1024, 1024, device=cuda_card)
    torch.cuda.synchronize()
    with spans.record() as rec, profile(activities=[ProfilerActivity.CUDA]) as prof:
        for name in ("a", "b"):
            with spans.span(name):
                for _ in range(5):
                    x = (x @ x).tanh_()
            time.sleep(0.005)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    launched = {e.correlation_id(): e.start_ns() for e in events
                if e.device_type() != cuda and e.correlation_id() and e.name().startswith("cu")}
    kernels = [e for e in events if e.device_type() == cuda]
    assert len(kernels) >= 10
    slack = 500_000                                         # 0.5 ms; the spans are 5 ms apart
    held = {"a": 0, "b": 0}
    for k in kernels:
        assert k.correlation_id() in launched, k.name()
        t = launched[k.correlation_id()]
        inside = [s.name for s in rec.spans
                  if rec.to_profiler_ns(s.start_ns) - slack <= t <= rec.to_profiler_ns(s.end_ns)
                  + slack]
        assert len(inside) == 1, (k.name(), inside)
        held[inside[0]] += 1
    assert held["a"] == held["b"] == len(kernels) // 2


# -- the fused AdamW (kernels/adamw.py) ------------------------------------------
# leaf sizes with tails that fill no block of either kernel (2048 and 4096
# elements), one above a whole sweep of the sum of squares' programs
ADAMW_SHAPES = {"a": (5,), "b": (3, 700), "c": (129, 1000), "d": (2200, 1031)}
ADAMW_DT = pytest.mark.parametrize("gdt,pdt", [(g, p) for g in ("bfloat16", "float32")
                                               for p in ("bfloat16", "float32")])


def _adamw_tree(dev, dtype, seed, scale=1.0):
    return {k: (scale * t).to(dtype) for k, t in
            zip(ADAMW_SHAPES, _card_inputs(dev, ADAMW_SHAPES.values(), torch.float32, seed))}


@ADAMW_DT
def test_adamw_kernel_matches_plain_bits_on_card(cuda_card, gdt, pdt):
    """One fused update of each leaf against the plain version on the same
    inputs and hyperparameters: m, v, the master weights and the param
    equal bit for bit (the same float32 operations in the same order)."""
    from repro_torch.kernels.adamw import adamw_plain, adamw_triton
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    hyper = torch.tensor([0.37, 3e-4, 0.271, 0.0975], device=cuda_card)
    for k, shape in ADAMW_SHAPES.items():
        g, m, v, w = _card_inputs(cuda_card, [shape] * 4, torch.float32, 21)
        g, v = g.to(DTYPES[gdt]), v.abs() * 1e-3
        got = [t.clone() for t in (m, v, w)] + [torch.empty(shape, dtype=DTYPES[pdt],
                                                             device=cuda_card)]
        adamw_triton(g, *got, hyper, **kw)
        adamw_plain(g, m, v, w, hyper, **kw)
        for name, a, b in zip("mvwp", got, (m, v, w, w.to(DTYPES[pdt]))):
            assert torch.equal(a, b), (k, name, (a.float() - b.float()).abs().max())


@ADAMW_DT
@pytest.mark.parametrize("clip", [0.05, 1e3], ids=["clip_active", "clip_inactive"])
def test_fused_update_matches_the_plain_loop_on_card(cuda_card, monkeypatch, gdt, pdt, clip):
    """Four steps of ``optim.update`` on the kernels against the plain loop
    on the card (``kernels.ops`` sent down its CPU route), from one state and
    on the same grads: m, v and the master weights within 1e-5 of each leaf's
    max (the clip's norm is summed in another order, so the clip scale may
    differ in its last bits), each param within one ulp of its dtype; one
    ``adamw`` and one ``grad_sumsq`` launch a leaf a step."""
    from repro_torch import optim
    cfg = optim.AdamWConfig(lr=1e-2, grad_clip=clip)
    steps, sides = 4, []
    for fused in (True, False):
        if not fused:
            monkeypatch.setattr(ops, "_on_cuda", lambda t, what: False)
        params = _adamw_tree(cuda_card, DTYPES[pdt], 30)
        st = optim.init(params)
        ops.reset_launches()
        for i in range(steps):
            grads = _adamw_tree(cuda_card, DTYPES[gdt], 40 + i, scale=0.3)
            params, st, stats = optim.update(grads, st, params, cfg, lr_scale=0.5 + 0.25 * i)
        sides.append((params, st, float(stats["grad_norm"]), dict(ops.LAUNCHES)))
    (p1, s1, n1, l1), (p0, s0, n0, l0) = sides
    assert l1["adamw"] == l1["grad_sumsq"] == steps * len(ADAMW_SHAPES)
    assert l0["adamw"] == l0["grad_sumsq"] == 0
    assert n1 == pytest.approx(n0, rel=1e-6)
    for k in ADAMW_SHAPES:
        for name, a, b in (("m", s1.m, s0.m), ("v", s1.v, s0.v), ("master", s1.master, s0.master)):
            assert _rel_err(a[k], b[k]) < 1e-5, (k, name)
        ulp = torch.finfo(DTYPES[pdt]).eps * p0[k].float().abs()
        assert ((p1[k].float() - p0[k].float()).abs() <= ulp).all(), k


def test_fused_update_runs_without_host_sync(cuda_card):
    """A warmed-up ``optim.update`` on the card under
    ``torch.cuda.set_sync_debug_mode("error")``: the norm, the clip scale,
    lr and the bias corrections stay on the device."""
    from repro_torch import optim
    params = _adamw_tree(cuda_card, torch.bfloat16, 50)
    st = optim.init(params)
    cfg = optim.AdamWConfig()
    grads = _adamw_tree(cuda_card, torch.bfloat16, 51)
    params, st, _ = optim.update(grads, st, params, cfg)
    torch.cuda.synchronize()
    ops.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        params, st, stats = optim.update(grads, st, params, cfg,
                                         lr_scale=optim.constant(st.step.float()))
        params, st, stats = optim.update(grads, st, params, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ops.LAUNCHES["adamw"] == ops.LAUNCHES["grad_sumsq"] == 2 * len(ADAMW_SHAPES)
    assert torch.isfinite(stats["grad_norm"]) and int(st.step) == 3


@pytest.mark.parametrize("gdt", ["bfloat16", "float32"])
def test_grad_norm_repeats_bit_for_bit_on_card(cuda_card, gdt):
    """``global_norm`` on the kernel gives the same bits in two calls, and
    the float64 norm within 1e-6."""
    from repro_torch import optim
    grads = _adamw_tree(cuda_card, DTYPES[gdt], 60)
    a, b = optim.global_norm(grads), optim.global_norm(grads)
    assert a.dtype == torch.float32 and a.shape == ()
    assert torch.equal(a, b)
    want = torch.sqrt(sum(t.double().square().sum() for t in grads.values()))
    assert float(a) == pytest.approx(float(want), rel=1e-6)


# -- Zamba2-7B: head dim 224 with a passed softmax scale, grouped SSD ---------
ZAMBA2_SCALE = (224 / 2) ** -0.5


@ATTN_DTYPE
@pytest.mark.parametrize("B,S,H,K,window", [
    (2, 1, 1, 1, None), (2, 17, 2, 2, None), (2, 65, 2, 2, 64), (2, 300, 4, 4, None),
    (1, 129, 5, 1, None), (1, 2048, 32, 32, None)])
def test_flash_kernel_hd224_with_scale_on_card(cuda_card, B, S, H, K, window, dtype):
    """hd 224 (a row's fourth box half zero-filled, P.V as two N = 128
    halves) with Zamba2's scale (hd/2)^-1/2 passed in, forward and lse: one
    row, ragged tiles, a window, GQA 5:1, and the shared block's 32 heads at
    S 2048."""
    td, tol = DTYPES[dtype], TOL[dtype]
    q, k, v = _card_inputs(cuda_card, [(B, S, H, 224), (B, S, K, 224), (B, S, K, 224)], td, 21)
    out, lse = flash_attention_cuda(q, k, v, window=window, return_lse=True,
                                    softmax_scale=ZAMBA2_SCALE)
    # against the plain version on the inputs widened to float32: in bf16 the
    # plain version rounds P and the output itself (at this scale's sharper
    # softmax one element of 144,480 at GQA 5:1 differed by 0.027 from it)
    want = flash_attention_plain(q.float(), k.float(), v.float(), window=window,
                                 softmax_scale=ZAMBA2_SCALE)
    torch.testing.assert_close(out.float(), want, atol=tol, rtol=tol)
    want = flash_attention_lse_plain(q, k, window=window, softmax_scale=ZAMBA2_SCALE)
    torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-4)


@ATTN_DTYPE
@pytest.mark.parametrize("B,S,H,K,window", [
    (2, 1, 1, 1, None), (2, 17, 2, 2, None), (2, 130, 2, 2, 64), (1, 129, 5, 1, None),
    (1, 1024, 32, 32, None)])
def test_flash_bwd_kernel_hd224_with_scale_on_card(cuda_card, B, S, H, K, window, dtype):
    """The backward at hd 224 with the scale passed in: dq, dk and dv
    against the plain backward at the same scale (dq on the scale of
    max|dv| at S = 1, where it is zero)."""
    td = DTYPES[dtype]
    q, k, v, do = _card_inputs(cuda_card, [(B, S, H, 224), (B, S, K, 224), (B, S, K, 224),
                                           (B, S, H, 224)], td, 22)
    lse = flash_attention_lse_plain(q, k, window=window, softmax_scale=ZAMBA2_SCALE)
    o = flash_attention_plain(q, k, v, window=window, softmax_scale=ZAMBA2_SCALE).contiguous()
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, window=window,
                                   softmax_scale=ZAMBA2_SCALE)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, window=window,
                                     softmax_scale=ZAMBA2_SCALE)
    top = float(want[2].float().abs().max())
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == td and g.shape == w.shape
        assert _rel_err(g, w, top if S == 1 else None) < GRAD_TOL[dtype], name


@ATTN_DTYPE
@pytest.mark.parametrize("hd", [64, 112, 128, 256])
def test_flash_default_scale_is_one_over_sqrt_hd_on_card(cuda_card, hd, dtype):
    """No scale passed gives the bits of 1/sqrt(hd) passed, forward and
    backward (the value the kernels computed inside before they took one),
    and through ``ops.flash_attention``'s autograd Function at Zamba2's
    scale the gradients of the plain version."""
    td = DTYPES[dtype]
    q, k, v, do = _card_inputs(cuda_card, [(2, 130, 4, hd), (2, 130, 2, hd), (2, 130, 2, hd),
                                           (2, 130, 4, hd)], td, 23)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True)
    o2, lse2 = flash_attention_cuda(q, k, v, return_lse=True, softmax_scale=hd ** -0.5)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    for a, b in zip(flash_attention_bwd_cuda(q, k, v, o, lse, do),
                    flash_attention_bwd_cuda(q, k, v, o, lse, do, softmax_scale=hd ** -0.5)):
        assert torch.equal(a, b)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    plain = [t.float().requires_grad_() for t in (q, k, v)]
    (ops.flash_attention(*leaves, softmax_scale=ZAMBA2_SCALE).float() * do.float()).sum() \
        .backward()
    (flash_attention_plain(*plain, softmax_scale=ZAMBA2_SCALE) * do.float()).sum().backward()
    for a, b in zip(leaves, plain):
        assert _rel_err(a.grad, b.grad) < GRAD_TOL[dtype]


SSD_GROUPED = [((1, 1, 16, 4, 8, 8), 2), ((1, 2, 40, 6, 4, 12), 3), ((2, 3, 128, 12, 64, 64), 4),
               ((2, 2, 128, 112, 64, 64), 2), ((2, 16, 128, 112, 64, 64), 2)]


@pytest.mark.parametrize("la_kind", ["model", "mixed"])
@pytest.mark.parametrize("shape,G", SSD_GROUPED)
def test_ssd_kernel_grouped_matches_float64_on_card(cuda_card, shape, G, la_kind):
    """C and B in G groups (head h reads group h // (H/G)): one mma tile;
    Q, N and P off the tiles; 4 groups of 3; Zamba2-7B's 2 groups of 56
    heads (B 2 x S 4096 is 2 rows of 16 chunks of 128); held to the plain
    version in float64 at the ungrouped kernel's tolerances."""
    la, C, Bm, x = _ssd_bwd_inputs(cuda_card, shape, la_kind, seed=24, G=G)[:4]
    want = ssd_intra_chunk_plain(*(a.double() for a in (la, C, Bm, x)))
    for got, w, tol in zip(ops.ssd_intra_chunk(la, C, Bm, x), want, SSD_TOLS):
        torch.testing.assert_close(got, w.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("la_kind", ["model", "mixed"])
@pytest.mark.parametrize("shape,G", SSD_GROUPED + [((1, 2, 17, 6, 16, 20), 2)])
def test_ssd_bwd_kernel_grouped_matches_float64_on_card(cuda_card, shape, G, la_kind):
    """dla, dC, dB (each group's summed over its own heads) and dx against
    autograd through the plain forward in float64, within 1e-4 of each
    output's max (Q 17 too, which only the backward takes); and two
    head-block plans agree within 1e-6."""
    args = _ssd_bwd_inputs(cuda_card, shape, la_kind, seed=24, G=G)
    got = ssd_intra_chunk_bwd_cuda(*args)
    want = ssd_intra_chunk_bwd_plain(*(a.double() for a in args))
    for name, g, w in zip(("dla", "dC", "dB", "dx"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _rel_err(g.double(), w) < GRAD_TOL["float32"], name
    other = ssd_intra_chunk_bwd_cuda(*args, heads_per_group=max(1, shape[3] // G // 2))
    for name, a, b in zip(("dla", "dC", "dB", "dx"), got, other):
        assert _rel_err(a.double(), b.double()) < 1e-6, name


def test_zamba2_smoke_trains_on_card_as_on_cpu(cuda_card):
    """The smoke Zamba2-7B at head dim 64 (the kernels' smallest), float32,
    one loss and every gradient on the card (flash with the passed scale, the
    grouped SSD kernels and their backward, rmsnorm) against the CPU's plain
    path from the same weights, within 1e-3 of each leaf's max|grad|."""
    from repro_torch.configs.zamba2_7b_instruct import SMOKE
    from repro_torch.models import build_model
    model = build_model(SMOKE)
    cpu = model.init(torch.Generator().manual_seed(0))
    tok = torch.randint(0, SMOKE.vocab_size, (2, 96), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tok, "labels": tok.roll(-1, 1)}
    leaves = {}

    def run(dev):
        import torch.utils._pytree as pytree
        params = pytree.tree_map(lambda t: t.to(dev).requires_grad_(), cpu)
        loss, _ = model.loss(params, {k: v.to(dev) for k, v in batch.items()}, remat="full")
        loss.backward()
        leaves[dev.type] = pytree.tree_leaves(params)
        return float(loss)
    ops.reset_launches()
    card = run(cuda_card)
    assert ops.LAUNCHES["ssd_intra_chunk_bwd"] > 0 and ops.LAUNCHES["flash_attention_bwd"] > 0
    # every layer's conv: its forward and its recompute, then its backward
    assert ops.LAUNCHES["causal_conv_silu"] == 2 * SMOKE.n_layers
    assert ops.LAUNCHES["causal_conv_silu_bwd"] == SMOKE.n_layers
    assert card == pytest.approx(run(torch.device("cpu")), rel=1e-4)
    for a, b in zip(leaves["cuda"], leaves["cpu"]):
        assert _rel_err(a.grad.cpu(), b.grad) < 1e-3


# -- the causal conv with its bias and SiLU (kernels/causal_conv.py) ------------------
# (B, S, channels, W, row width of the tensor x is sliced from, first channel):
# Zamba2-7B's training xBC, the slice of in_proj's (2, 4096, 14704) output
# after z's 7168 channels (the backward's 256-row chunks); xlstm-1.3b's
# training x_in, the first half of (4, 2048, 8192) (128-row chunks, too few
# programs at 256); ragged lengths (1, 2, W-1 = 3; 77, off the forward's
# 32-row tile; 600, five of the backward's 128-row chunks, the last short)
# at channels off the channel blocks, one contiguous; narrower convs.
CONV_CASES = [(2, 4096, 7424, 4, 14704, 7168), (4, 2048, 4096, 4, 8192, 0),
              (2, 1, 200, 4, 520, 8), (2, 2, 200, 4, 520, 8), (3, 3, 200, 4, 520, 8),
              (2, 77, 200, 4, 520, 8), (2, 77, 200, 4, 200, 0), (2, 600, 200, 4, 520, 8),
              (2, 77, 200, 3, 520, 8), (1, 40, 72, 2, 72, 0), (1, 300, 72, 1, 100, 20)]


def _conv_case(dev, B, S, Ch, W, width, first, dtype, seed=11):
    """x as a strided slice of a wider tensor, w, b and an output gradient
    whose rows are apart too."""
    wide, w, b, gwide = _card_inputs(dev, [(B, S, width), (W, Ch), (Ch,), (B, S, Ch + 8)],
                                     dtype, seed)
    return wide[..., first:first + Ch], w * 0.5, b * 0.1, gwide[..., :Ch]


def _conv_close(got, want, dtype, name):
    """One rounding to bf16 (2^-9 relative) after float32 steps: 2^-8 of
    each element, and 1e-4 of the output's max|.| where the float32 sums
    cancel (dw and db sum up to 16,384 rows); float32: 1e-5 of each element
    and of max|.| (the sums' and the sigmoid's float32 rounding)."""
    rtol, atol = (2 ** -8, 1e-4) if dtype == torch.bfloat16 else (1e-5, 1e-5)
    got, want = got.detach().double(), want.detach().double()
    assert torch.isfinite(got).all(), name
    bad = (got - want).abs() > rtol * want.abs() + atol * float(want.abs().max())
    assert not bad.any(), (name, float((got - want).abs().max()), float(want.abs().max()))


@ATTN_DTYPE
@pytest.mark.parametrize("B,S,Ch,W,width,first", CONV_CASES)
def test_causal_conv_kernels_match_float64_on_card(cuda_card, B, S, Ch, W, width, first, dtype):
    """The forward and the backward (dx, dw, db) against the plain forward
    and autograd through it run in float64 on the same inputs; the output
    and dx contiguous, x read where it lies."""
    from repro_torch.kernels.causal_conv import (causal_conv_silu_bwd_triton,
                                                 causal_conv_silu_plain, causal_conv_silu_triton)
    dt = DTYPES[dtype]
    x, w, b, dy = _conv_case(cuda_card, B, S, Ch, W, width, first, dt)
    out = causal_conv_silu_triton(x, w, b)
    grads = causal_conv_silu_bwd_triton(x, w, b, dy)
    leaves = [t.double().requires_grad_() for t in (x, w, b)]
    want = causal_conv_silu_plain(*leaves)
    want_grads = torch.autograd.grad(want, leaves, dy.double())
    assert out.is_contiguous() and out.dtype == dt and grads[0].is_contiguous()
    _conv_close(out, want, dt, "y")
    for name, g, e, t in zip(("dx", "dw", "db"), grads, want_grads, (x, w, b)):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        _conv_close(g, e, dt, name)


def test_causal_conv_bwd_repeats_bit_for_bit_on_card(cuda_card):
    """No atomics: the backward gives the same bits in every call."""
    from repro_torch.kernels.causal_conv import causal_conv_silu_bwd_triton
    x, w, b, dy = _conv_case(cuda_card, *CONV_CASES[0], torch.bfloat16)
    first = causal_conv_silu_bwd_triton(x, w, b, dy)
    for _ in range(3):
        for a, c in zip(first, causal_conv_silu_bwd_triton(x, w, b, dy)):
            assert torch.equal(a, c)


def test_ops_causal_conv_autograd_on_card(cuda_card):
    """Through ``ops.causal_conv_silu``: one forward and one backward launch
    under autograd, one forward without it, and no other kernel."""
    x, w, b, dy = _conv_case(cuda_card, 2, 77, 200, 4, 520, 8, torch.bfloat16)
    wide = x._base.requires_grad_()
    xs, wg, bg = wide[..., 8:208], w.requires_grad_(), b.requires_grad_()
    ops.reset_launches()
    out = ops.causal_conv_silu(xs, wg, bg)
    out.backward(dy)
    with torch.inference_mode():
        ops.causal_conv_silu(xs, wg, bg)
    assert ops.LAUNCHES == {**dict.fromkeys(ops.KERNELS, 0), "causal_conv_silu": 2,
                            "causal_conv_silu_bwd": 1}
    assert wide.grad[..., :8].abs().max() == 0 and wg.grad is not None and bg.grad is not None
