"""The port's kernel modules against repro's Pallas kernels (interpret mode)
and pure-jnp oracles, over the sweeps of tests/test_kernels.py, and the
device dispatch of ``repro_torch.kernels.ops``. Each hand-written kernel
against its plain version on a CUDA card: tests/test_torch_cuda.py."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from tests.conftest import JAX_DRIFT_REASON, jax_api_drifted

jax_only = pytest.mark.skipif(jax_api_drifted(), reason=JAX_DRIFT_REASON)

import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_plain  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_plain  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_intra_chunk_plain  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, shapes, dtype):
    """The same values for both frameworks: float32 from numpy, each side
    rounding to the working dtype (round-to-nearest-even on both)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jd, td = DTYPES[dtype]
    return [jnp.asarray(a).astype(jd) for a in arrs], [torch.from_numpy(a).to(td) for a in arrs]


def _close(got, *wants, dtype):
    g = got.float().numpy()
    for w in wants:
        np.testing.assert_allclose(g, np.asarray(w, np.float32),
                                   atol=TOL[dtype], rtol=TOL[dtype])


@jax_only
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,S,H,K,hd,T,window",
    [
        (2, 128, 4, 2, 64, 128, None),
        (1, 256, 8, 8, 32, 256, None),     # MHA
        (2, 128, 4, 1, 64, 128, None),     # MQA
        (1, 128, 6, 2, 128, 128, 64),      # sliding window
        (1, 64, 2, 2, 16, 64, 16),
        (1, 128, 4, 2, 256, 128, 64),      # gemma3: hd 256, G 2, a local window
    ],
)
def test_flash_attention_plain_matches_pallas(B, S, H, K, hd, T, window, dtype):
    from repro.kernels import ops, ref
    (q, k, v), (tq, tk, tv) = _inputs(0, [(B, S, H, hd), (B, T, K, hd), (B, T, K, hd)], dtype)
    got = flash_attention_plain(tq, tk, tv, causal=True, window=window)
    pallas = ops.flash_attention(q, k, v, causal=True, window=window, block_q=64, block_k=64)
    oracle = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    _close(got, pallas, oracle, dtype=dtype)


@jax_only
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,hd,T", [
    (2, 128, 4, 2, 64, 256),           # the cross-attention's S != T
    (2, 128, 6, 6, 64, 128),           # the encoder's S = T, MHA (whisper's 6 heads)
    (1, 64, 4, 1, 32, 192),            # MQA, more keys than queries
])
def test_flash_attention_plain_noncausal_matches_pallas(B, S, H, K, hd, T, dtype):
    """Whisper's cases: non-causal, and S queries against T keys."""
    from repro.kernels import ops, ref
    (q, k, v), (tq, tk, tv) = _inputs(4, [(B, S, H, hd), (B, T, K, hd), (B, T, K, hd)], dtype)
    got = flash_attention_plain(tq, tk, tv, causal=False)
    pallas = ops.flash_attention(q, k, v, causal=False, block_q=64, block_k=64)
    oracle = ref.flash_attention_ref(q, k, v, causal=False)
    _close(got, pallas, oracle, dtype=dtype)


@jax_only
@pytest.mark.parametrize("S,T", [(128, 256), (40, 64), (64, 64)])
def test_flash_attention_bwd_plain_noncausal_matches_jax_grad(S, T):
    """The explicit backward, non-causal with S != T, against jax.grad
    through ``repro.kernels.ref.flash_attention_ref`` (float32, GQA G 2):
    each of dq, dk, dv within 1e-5 of its max; the lse against the log-sum-exp
    of the reference's scores."""
    import jax
    from repro.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_plain,
                                                     flash_attention_lse_plain)
    B, H, K, hd = 2, 4, 2, 32
    (q, k, v, do), (tq, tk, tv, tdo) = _inputs(
        8, [(B, S, H, hd), (B, T, K, hd), (B, T, K, hd), (B, S, H, hd)], "float32")
    out, vjp = jax.vjp(lambda a, b, c: ref.flash_attention_ref(a, b, c, causal=False), q, k, v)
    want = vjp(do)
    lse = flash_attention_lse_plain(tq, tk, causal=False)
    s = jnp.einsum("bskgd,btkd->bkgst", q.reshape(B, S, K, H // K, hd), k) * hd ** -0.5
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax.nn.logsumexp(s, -1)).reshape(B, H, S),
                               atol=1e-5, rtol=1e-5)
    got = flash_attention_bwd_plain(tq, tk, tv, torch.from_numpy(np.array(out)), lse, tdo,
                                    causal=False)
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.max(np.abs(g.numpy() - w)) / np.max(np.abs(w)) < 1e-5


@jax_only
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_len", [37, 128])
def test_decode_attention_plain_matches_pallas_hd256(kv_len, dtype):
    """gemma3's head dim over a 128-slot ring, partly filled and full."""
    from repro.kernels import ops, ref
    B, H, K, hd, T = 2, 4, 2, 256, 128
    (q, k, v), (tq, tk, tv) = _inputs(2, [(B, 1, H, hd), (B, T, K, hd), (B, T, K, hd)], dtype)
    got = decode_attention_plain(tq, tk, tv, kv_len=torch.tensor(kv_len, dtype=torch.int32))
    pallas = ops.decode_attention(q, k, v, kv_len=kv_len, block_k=64)
    oracle = ref.decode_attention_ref(q, k, v, kv_len=kv_len)
    _close(got, pallas, oracle, dtype=dtype)


def test_head_dims_of_the_wrappers():
    """hd 256 for the forward, decode and backward kernels, hd 224 for the
    flash forward and backward only (the wrappers refuse any other head dim);
    on the CPU autograd through the plain version takes any head dim."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    assert fa.HEAD_DIMS == (64, 112, 128, 224, 256)
    assert da.HEAD_DIMS == (64, 112, 128, 256)
    assert fa.BWD_HEAD_DIMS == fa.HEAD_DIMS
    q = torch.randn(1, 8, 2, 256, requires_grad=True)
    tops.flash_attention(q, q.detach(), q.detach()).sum().backward()
    assert q.grad.shape == q.shape


@jax_only
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_len", [1, 37, 100, 512])
@pytest.mark.parametrize("window", [None, 64])
def test_decode_attention_plain_matches_pallas(kv_len, window, dtype):
    from repro.kernels import ops, ref
    B, H, K, hd, T = 2, 8, 4, 64, 512
    (q, k, v), (tq, tk, tv) = _inputs(1, [(B, 1, H, hd), (B, T, K, hd), (B, T, K, hd)], dtype)
    # kv_len as the 0-dim int32 tensor the model passes, and as a plain int
    for tl in (torch.tensor(kv_len, dtype=torch.int32), kv_len):
        got = decode_attention_plain(tq, tk, tv, kv_len=tl, window=window)
        pallas = ops.decode_attention(q, k, v, kv_len=kv_len, window=window, block_k=128)
        oracle = ref.decode_attention_ref(q, k, v, kv_len=kv_len, window=window)
        _close(got, pallas, oracle, dtype=dtype)


@jax_only
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 64, 256), (2, 33, 128), (1, 1, 512)])
def test_rmsnorm_plain_matches_pallas(shape, dtype):
    from repro.kernels import ops, ref
    (x, s), (tx, ts) = _inputs(3, [shape, shape[-1:]], dtype)
    got = rmsnorm_plain(tx, ts)
    _close(got, ops.rmsnorm(x, s), ref.rmsnorm_ref(x, s), dtype=dtype)


def test_ops_dispatch_cpu_to_plain_without_counting(monkeypatch):
    """CPU tensors take the plain versions, and no launch is counted. Each
    plain version in ``kernels.ops`` is wrapped to record its call, so the
    test shows which function ran (with and without autograd) rather than
    comparing two runs of the same BLAS code bit for bit."""
    calls = []

    def recording(name):
        plain = getattr(tops, name)

        def wrapped(*args, **kw):
            calls.append(name)
            return plain(*args, **kw)
        monkeypatch.setattr(tops, name, wrapped)

    for name in ("rmsnorm_plain", "flash_attention_plain", "decode_attention_plain",
                 "ssd_intra_chunk_plain", "adamw_plain", "grad_sumsq_plain",
                 "causal_conv_silu_plain"):
        recording(name)
    tops.reset_launches()
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    s = torch.ones(64)
    assert tops.rmsnorm(x, s).shape == x.shape
    assert tops.rmsnorm(x.requires_grad_(), s).requires_grad
    q = torch.from_numpy(rng.standard_normal((1, 16, 4, 64)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 16, 2, 64)).astype(np.float32))
    assert tops.flash_attention(q, k, k, window=8).shape == q.shape
    assert tops.flash_attention(q.requires_grad_(), k, k).requires_grad
    kl = torch.tensor(5, dtype=torch.int32)
    assert tops.decode_attention(q[:, :1], k, k, kv_len=kl).shape == (1, 1, 4, 64)
    la = -torch.from_numpy(np.abs(rng.standard_normal((1, 2, 32, 4))).astype(np.float32))
    C, Bm = (torch.from_numpy(rng.standard_normal((1, 2, 32, 1, 16)).astype(np.float32))
             for _ in range(2))
    xs = torch.from_numpy(rng.standard_normal((1, 2, 32, 4, 16)).astype(np.float32))
    assert len(tops.ssd_intra_chunk(la, C, Bm, xs)) == 3
    assert tops.ssd_intra_chunk(la, C, Bm, xs.requires_grad_())[0].requires_grad
    g, m, v, w = (torch.from_numpy(rng.standard_normal(37).astype(np.float32)) for _ in range(4))
    p = w.to(torch.bfloat16)
    tops.adamw(g, m, v.abs_(), w, p, torch.tensor([1.0, 1e-2, 0.1, 0.05]),
               b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    assert torch.equal(p, w.to(torch.bfloat16))
    assert tops.grad_sumsq([g, x]).shape == ()
    xc = torch.from_numpy(rng.standard_normal((2, 9, 6)).astype(np.float32))
    wc, bc = torch.ones(4, 6), torch.zeros(6)
    assert tops.causal_conv_silu(xc, wc, bc).shape == xc.shape
    assert tops.causal_conv_silu(xc, wc.requires_grad_(), bc).requires_grad
    assert calls == ["rmsnorm_plain", "rmsnorm_plain", "flash_attention_plain",
                     "flash_attention_plain", "decode_attention_plain",
                     "ssd_intra_chunk_plain", "ssd_intra_chunk_plain", "adamw_plain",
                     "grad_sumsq_plain", "causal_conv_silu_plain", "causal_conv_silu_plain"]
    assert tops.LAUNCHES == dict.fromkeys(tops.KERNELS, 0)
    assert set(tops.KERNELS) == {"rmsnorm", "rmsnorm_bwd", "flash_attention",
                                 "flash_attention_bwd", "decode_attention",
                                 "ssd_intra_chunk", "ssd_intra_chunk_bwd", "adamw",
                                 "grad_sumsq", "causal_conv_silu", "causal_conv_silu_bwd"}


def test_ops_refuse_other_devices():
    x = torch.ones(2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tops.rmsnorm(x, torch.ones(8, device="meta"))


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel launchers never take a CPU tensor (no silent plain path)."""
    from repro_torch.kernels.adamw import adamw_triton, grad_sumsq_triton
    from repro_torch.kernels.causal_conv import (causal_conv_silu_bwd_triton,
                                                 causal_conv_silu_triton)
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_triton, rmsnorm_triton
    from repro_torch.kernels.ssd_scan import ssd_intra_chunk_bwd_cuda, ssd_intra_chunk_cuda
    x = torch.ones(1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rmsnorm_triton(x, torch.ones(64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        rmsnorm_bwd_triton(x, torch.ones(64), x, x[..., 0])
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_intra_chunk_bwd_cuda(x, x, x, x[..., None], x[..., None], x, x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(x, x, x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        decode_attention_cuda(x[:, :1], x, x, kv_len=torch.tensor(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_intra_chunk_cuda(x, x, x, x[..., None])
    with pytest.raises(ValueError, match="CUDA tensors"):
        adamw_triton(x, x, x, x, x, torch.ones(4), b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        grad_sumsq_triton([x])
    xc, w = x[0], torch.ones(4, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        causal_conv_silu_triton(xc, w, w[0])
    with pytest.raises(ValueError, match="CUDA tensors"):
        causal_conv_silu_bwd_triton(xc, w, w[0], xc)


@pytest.mark.parametrize("shape,match", [
    ((1, 1, 12, 2, 8, 8), "Q % 8 == 0"),          # Q off the 8-row step
    ((1, 1, 136, 2, 8, 8), "Q <= 128"),
    ((1, 1, 16, 2, 6, 8), "N % 4 == 0"),
    ((1, 1, 16, 2, 8, 10), "P % 4 == 0"),
])
def test_ssd_contract_errors(shape, match):
    """The kernel's contract is checked before any launch, on any device."""
    from repro_torch.kernels.ssd_scan import check_inputs
    B, nc, Q, H, N, P = shape
    args = [torch.zeros(s) for s in ((B, nc, Q, H), (B, nc, Q, 1, N), (B, nc, Q, 1, N),
                                     (B, nc, Q, H, P))]
    with pytest.raises(ValueError, match=match):
        check_inputs(*args)


def test_ssd_contract_types_layouts_and_edges():
    """float64, mismatched and non-contiguous inputs raise, and so do C and
    B without their group dim, (B, nc, Q, N); the edge shapes the kernel
    pads (Q 16 with N = P = 8; Q 40, N 4, P 12; Q 128) pass in one group,
    and C and B in 2 groups of 56 heads; 3 groups of 112 heads raise."""
    from repro_torch.kernels.ssd_scan import check_inputs

    def make(B, nc, Q, H, N, P, dtype=torch.float32):
        return [torch.zeros(s, dtype=dtype) for s in
                ((B, nc, Q, H), (B, nc, Q, 1, N), (B, nc, Q, 1, N), (B, nc, Q, H, P))]
    with pytest.raises(ValueError, match="float32"):
        check_inputs(*make(1, 1, 16, 1, 8, 8, torch.float64))
    la, C, Bm, x = make(1, 1, 16, 2, 8, 8)
    with pytest.raises(ValueError, match="do not match"):
        check_inputs(la, C, Bm, x[:, :, :, :1])
    with pytest.raises(ValueError, match="bad shapes"):
        check_inputs(la, C, Bm[..., :4], x)
    with pytest.raises(ValueError, match="contiguous"):
        check_inputs(la, C, Bm, x.transpose(3, 4).contiguous().transpose(3, 4))
    with pytest.raises(ValueError, match="bad shapes"):
        check_inputs(la, C[:, :, :, 0], Bm[:, :, :, 0], x)
    for shape in ((1, 1, 16, 1, 8, 8), (1, 2, 40, 3, 4, 12), (2, 2, 128, 113, 64, 64)):
        B, nc, Q, H, N, P = shape
        assert check_inputs(*make(*shape)) == (B, nc, Q, H, 1, N, P)
    # C and B in groups: (B, nc, Q, G, N), G dividing H
    la, _, _, x = make(2, 2, 128, 112, 64, 64)
    grouped = torch.zeros((2, 2, 128, 2, 64))
    assert check_inputs(la, grouped, grouped, x) == (2, 2, 128, 112, 2, 64, 64)
    with pytest.raises(ValueError, match="do not match"):
        odd = torch.zeros((2, 2, 128, 3, 64))
        check_inputs(la, odd, odd, x)


def test_heads_per_block_bounds():
    """A group holds 1 to min(H, MAX_HEADS_PER_BLOCK) heads (the kernel's
    shared memory and scan take at most 16), and where the card has an SM for
    every (chunk, head), each block takes one head."""
    from repro_torch.kernels.ssd_scan import MAX_HEADS_PER_BLOCK, heads_per_block
    for BC in (1, 4, 32, 64):
        for H in (1, 5, 16, 17, 112, 113):
            for sm in (1, 114, 132):
                hg = heads_per_block(BC, H, sm)
                assert 1 <= hg <= min(H, MAX_HEADS_PER_BLOCK), (BC, H, sm, hg)
                if BC * H <= sm:
                    assert hg == 1, (BC, H, sm, hg)


def test_heads_per_block_main_shape():
    """zamba2-7b prefill on an H100: B 8 x 4 chunks, 112 heads, 132 SMs ->
    groups of 14 heads, 8 groups a chunk, 256 blocks in two waves. The
    backward (no cap on a group) at zamba2's training shape, B 4 x 16
    chunks: groups of 56 heads, 128 blocks in one wave (as
    ``bwd_heads_per_block`` plans it now)."""
    from repro_torch.kernels.ssd_scan import heads_per_block
    assert heads_per_block(32, 112, 132) == 14
    assert heads_per_block(1, 1, 132) == 1
    assert heads_per_block(64, 112, 132, max_heads=112) == 56
    assert heads_per_block(1, 113, 132, max_heads=113) == 1


def test_bwd_heads_per_block_plan():
    """The backward's plan: a group holds 1 to H heads, as evenly as its
    number of groups allows (no group larger than ceil(H / groups)); its
    blocks, one an SM, fill whole waves no worse than groups of one head
    or of all H would (each block also costs ``BWD_BLOCK_COST`` heads); and
    on an H100 (132 SMs) zamba2's training shape (B 4 x 16 chunks, H 112)
    takes groups of 56, 128 blocks in one wave, and its prefill shape (B 8
    x 4 chunks) groups of 28."""
    import math

    from repro_torch.kernels.ssd_scan import BWD_BLOCK_COST, bwd_heads_per_block

    def cost(BC, H, sm, hg):
        return math.ceil(BC * math.ceil(H / hg) / sm) * (hg + BWD_BLOCK_COST)
    for BC in (1, 4, 32, 64, 133):
        for H in (1, 5, 17, 112, 113):
            for sm in (1, 114, 132):
                hg = bwd_heads_per_block(BC, H, sm)
                groups = math.ceil(H / hg)
                assert 1 <= hg <= H and hg == math.ceil(H / groups), (BC, H, sm, hg)
                blocks = BC * groups
                assert blocks <= math.ceil(blocks / sm) * sm
                assert cost(BC, H, sm, hg) <= min(cost(BC, H, sm, 1), cost(BC, H, sm, H))
    assert bwd_heads_per_block(64, 112, 132) == 56
    assert bwd_heads_per_block(32, 112, 132) == 28


@pytest.mark.parametrize("rows,d", [(8192, 1024), (8192, 3072), (8192, 3840), (131072, 256),
                                    (65536, 256), (8192, 3584), (37, 3840), (1, 128)])
@pytest.mark.parametrize("n_sm", [1, 132])
def test_rmsnorm_bwd_plan(rows, d, n_sm):
    """The backward's launch: the forward's blocks, at most two programs an
    SM and never more than there are row blocks (each program writes one
    row of column partials), 32-column programs summing them."""
    from repro_torch.kernels.rmsnorm import bwd_plan
    p = bwd_plan(rows, d, n_sm)
    assert p["BLOCK_D"] >= d and p["BLOCK_D"] & (p["BLOCK_D"] - 1) == 0
    assert p["BLOCK_D"] < 2 * d or d == 1
    assert p["BLOCK_R"] * p["BLOCK_D"] <= max(4096, p["BLOCK_D"])
    assert 1 <= p["nprog"] <= min(2 * n_sm, -(-rows // p["BLOCK_R"]))
    assert p["colsum_block"] == 32 and p["num_warps"] in (4, 8)


# -- the decode kernel's split plan and argument packing (no card needed) --------
SPLIT_SHAPES = [(B, K, T, sm) for B in (1, 8, 64) for K in (1, 8, 32)
                for T in (1, 17, 544, 4096) for sm in (1, 132)]


@pytest.mark.parametrize("B,K,T,sm", SPLIT_SHAPES)
def test_plan_splits_partitions_the_cache(B, K, T, sm):
    """Chunks are multiples of 16 and cover every column of [0, T) exactly
    once; the card is filled (B*K*nsplit >= SMs) unless T is too short."""
    from repro_torch.kernels.decode_attention import plan_splits
    chunk, nsplit = plan_splits(B, K, T, sm)
    assert chunk % 16 == 0 and chunk > 0
    covered = np.zeros(T, np.int64)
    for s in range(nsplit):
        covered[s * chunk:min((s + 1) * chunk, T)] += 1
    assert (covered == 1).all()
    assert (nsplit - 1) * chunk < T <= nsplit * chunk
    assert B * K * nsplit >= sm or nsplit == -(-T // 16)


def test_plan_splits_main_shapes_and_no_kv_len():
    """The split counts the kernel's note gives at the serving shapes (132
    SMs), and a plan that no kv_len can reach: it takes only (B, K, T, SMs)."""
    import inspect
    from repro_torch.kernels.decode_attention import plan_splits
    assert plan_splits(8, 32, 544, 132) == (272, 2)    # zamba2-7b: B*K = 256
    assert plan_splits(8, 8, 544, 132) == (80, 7)      # qwen3-14b: B*K = 64
    assert plan_splits(8, 8, 1024, 132) == (128, 8)    # gemma3-12b's local ring
    assert plan_splits(8, 8, 1568, 132) == (208, 8)    # gemma3-12b global, prompt 1536
    assert list(inspect.signature(plan_splits).parameters) == ["B", "K", "T", "sm_count"]


def _c_params(source: str, fn: str) -> list[tuple[str, str]]:
    """(type, name) of each parameter of ``extern "C" int fn(...)`` in a
    csrc file."""
    import re
    from pathlib import Path
    text = (Path(__file__).resolve().parents[1] / "src/repro_torch/csrc" / source).read_text()
    m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
    assert m, f"{fn} not found in {source}"
    out = []
    for p in m.group(1).split(","):
        p = " ".join(p.split())
        name = re.findall(r"\w+$", p)[0]
        out.append((p[: -len(name)].strip(), name))
    return out


def _ctype(c_type: str):
    import ctypes
    return ctypes.c_void_p if c_type.endswith("*") else {"int": ctypes.c_int,
                                                         "double": ctypes.c_double}[c_type]


@pytest.mark.parametrize("source,fn,module", [
    ("decode_attention.cu", "decode_attention_fwd", "decode_attention"),
    ("flash_attention.cu", "flash_attention_fwd", "flash_attention"),
    ("flash_attention_bwd.cu", "flash_attention_bwd", "flash_attention"),
    ("ssd_intra_chunk.cu", "ssd_intra_chunk_fwd", "ssd_scan"),
    ("ssd_intra_chunk_bwd.cu", "ssd_intra_chunk_bwd", "ssd_scan"),
])
def test_ctypes_signatures_match_c(source, fn, module):
    """``_SIGNATURES`` gives ctypes the C entry point's argument types."""
    import importlib
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    sigs = {**mod._SIGNATURES, **getattr(mod, "_BWD_SIGNATURES", {})}
    assert sigs[fn] == [_ctype(t) for t, _ in _c_params(source, fn)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_argument_packing_matches_c(dtype):
    """The wrapper's packed arguments sit where the C signature names them:
    the chunk length, the one scratch buffer sized for m, l and acc, and no
    value that depends on kv_len beyond its pointer."""
    from repro_torch.kernels import decode_attention as da
    B, T, H, K, hd = 2, 100, 10, 2, 112
    q = torch.zeros(B, 1, H, hd, dtype=dtype)
    k = torch.zeros(B, T, K, hd, dtype=dtype)
    chunk, nsplit = da.plan_splits(B, K, T, 132)
    scratch = torch.empty(da.scratch_numel(B, H, hd, nsplit))
    assert scratch.numel() == 2 * B * H * nsplit + B * H * nsplit * hd
    out = torch.empty_like(q)
    packs = [da._fwd_args(q, k, k, torch.tensor(n, dtype=torch.int32), out, None, scratch, 64,
                          chunk, 7)
             for n in (1, 99)]
    names = [n for _, n in _c_params("decode_attention.cu", "decode_attention_fwd")]
    assert len(packs[0]) == len(names) == len(da._SIGNATURES["decode_attention_fwd"])
    got = dict(zip(names, packs[0]))
    assert (got["B"], got["T_len"], got["H"], got["K"], got["hd"]) == (B, T, H, K, hd)
    assert (got["window"], got["chunk"], got["stream"]) == (64, chunk, 7)
    assert got["dtype"] == da.DTYPE_CODES[dtype]
    assert got["part"] == scratch.data_ptr() and got["o"] == out.data_ptr()
    assert got["lse"] is None                     # a null pointer: no lse asked for
    differ = [n for n, a, b in zip(names, *packs) if a != b]
    assert differ == ["kv_len"]
    lse = torch.empty(B, H)
    with_lse = dict(zip(names, da._fwd_args(q, k, k, torch.tensor(1, dtype=torch.int32), out,
                                            lse, scratch, 64, chunk, 7)))
    assert with_lse["lse"] == lse.data_ptr()


def _csrc_copy(tmp_path, monkeypatch):
    """The build module pointed at a copy of csrc in a temporary directory."""
    import shutil
    from repro_torch.kernels import build
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    return build, csrc


@pytest.mark.parametrize("edited,moved", [
    ("sm90.cuh", {"flash_attention", "flash_attention_bwd"}),
    ("flash_attention_bwd.cu", {"flash_attention_bwd"}),
    ("decode_attention.cu", {"decode_attention"}),
])
def test_build_target_follows_included_headers(tmp_path, monkeypatch, edited, moved):
    """A library's path hashes its source and the csrc headers it includes:
    editing the shared Hopper header moves both flash libraries and no other,
    editing a source moves only its own."""
    build, csrc = _csrc_copy(tmp_path, monkeypatch)
    before = {n: build._target(n) for n in build.sources()}
    with open(csrc / edited, "a") as f:
        f.write("\n// edited\n")
    after = {n: build._target(n) for n in build.sources()}
    assert {n for n in before if before[n] != after[n]} == moved
    assert all(p.parent == tmp_path / "build" for p in after.values())


def test_build_sources_are_the_cu_files(tmp_path, monkeypatch):
    """``sources()`` names each .cu once and no header; the flash sources
    include sm90.cuh, the others no local header."""
    build, csrc = _csrc_copy(tmp_path, monkeypatch)
    assert build.sources() == ["decode_attention", "flash_attention", "flash_attention_bwd",
                               "ssd_intra_chunk", "ssd_intra_chunk_bwd"]
    assert (csrc / "sm90.cuh").exists()
    for name in build.sources():
        want = [csrc / "sm90.cuh"] if name.startswith("flash") else []
        assert build._local_includes(csrc / f"{name}.cu") == want


@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("kv_len", [1, 37, 100])
def test_decode_attention_plain_lse(kv_len, window):
    """The lse output is the log-sum-exp of each row's scaled scores over
    its valid columns, float32 (B, H)."""
    B, H, K, hd, T = 2, 8, 4, 64, 100
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(s, generator=g) for s in [(B, 1, H, hd), (B, T, K, hd), (B, T, K, hd)])
    kl = torch.tensor(kv_len, dtype=torch.int32)
    out, lse = decode_attention_plain(q, k, v, kv_len=kl, window=window, return_lse=True)
    torch.testing.assert_close(out, decode_attention_plain(q, k, v, kv_len=kl, window=window))
    lo = 0 if window is None else max(0, kv_len - window)
    s = torch.einsum("bhd,bthd->bht", q[:, 0], k.repeat_interleave(H // K, dim=2))[..., lo:kv_len]
    want = torch.logsumexp(s.double() * hd ** -0.5, dim=-1)
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    torch.testing.assert_close(lse.double(), want, atol=1e-5, rtol=1e-5)


def test_decode_attention_plain_empty_cache():
    """kv_len 0: output 0 and lse -inf, no NaN (what a rank holding none of
    the valid rows of a sequence-sharded cache gives the merge)."""
    q, k = torch.randn(2, 1, 4, 32), torch.randn(2, 16, 2, 32)
    out, lse = decode_attention_plain(q, k, k, kv_len=torch.tensor(0, dtype=torch.int32),
                                      return_lse=True)
    assert torch.equal(out, torch.zeros_like(out))
    assert torch.isneginf(lse).all()


@pytest.mark.parametrize("kv_len", [5, 40, 64, 79])
def test_decode_attention_lse_merge_of_two_shards(kv_len):
    """Two halves of the cache, each with its local kv_len clamped into
    [0, T/2], merged by their lse: one pass over the whole cache (the merge
    ``kernels/sharded.py`` does across ranks)."""
    B, H, K, hd, T = 2, 8, 2, 64, 80
    g = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(s, generator=g) for s in [(B, 1, H, hd), (B, T, K, hd), (B, T, K, hd)])
    whole = decode_attention_plain(q, k, v, kv_len=torch.tensor(kv_len))
    parts = []
    for r in range(2):
        n = torch.clamp(torch.tensor(kv_len) - r * (T // 2), 0, T // 2).to(torch.int32)
        sl = slice(r * (T // 2), (r + 1) * (T // 2))
        parts.append(decode_attention_plain(q, k[:, sl], v[:, sl], kv_len=n, return_lse=True))
    lse = torch.stack([p[1] for p in parts])
    m = lse.max(0).values
    w = torch.exp(lse - m)
    merged = sum(p[0] * w[i][:, None, :, None] for i, p in enumerate(parts)) / w.sum(0)[:, None, :, None]
    torch.testing.assert_close(merged, whole, atol=1e-6, rtol=1e-6)


def test_bwd_sem_count_covers_every_q_tile():
    """The flash backward's dq counters: the wrapper allocates one for each
    (b, h, q tile) of the smallest q tile that the C source zeroes and
    indexes (``MIN_QT``), so every q tile of 32 or 64 rows has its own."""
    import re
    from pathlib import Path

    from repro_torch.kernels.flash_attention import bwd_sem_count
    text = (Path(__file__).resolve().parents[1] / "src/repro_torch/csrc"
            / "flash_attention_bwd.cu").read_text()
    assert int(re.search(r"constexpr int MIN_QT = (\d+);", text).group(1)) == 32
    for B, S, H in [(1, 1, 1), (2, 31, 3), (4, 2048, 24), (4, 1500, 6), (3, 65, 5)]:
        n = bwd_sem_count(B, S, H)
        assert n == B * H * -(-S // 32)
        for qb in (32, 64):
            last = ((B - 1) * H + H - 1) * -(-S // qb) + -(-S // qb) - 1
            assert last < n
