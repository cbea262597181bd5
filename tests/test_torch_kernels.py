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


def test_ops_dispatch_cpu_to_plain_without_counting():
    """CPU tensors take the plain versions, and no launch is counted."""
    tops.reset_launches()
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    s = torch.ones(64)
    assert torch.equal(tops.rmsnorm(x, s), rmsnorm_plain(x, s))
    q = torch.from_numpy(rng.standard_normal((1, 16, 4, 64)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 16, 2, 64)).astype(np.float32))
    assert torch.equal(tops.flash_attention(q, k, k, window=8),
                       flash_attention_plain(q, k, k, window=8))
    kl = torch.tensor(5, dtype=torch.int32)
    assert torch.equal(tops.decode_attention(q[:, :1], k, k, kv_len=kl),
                       decode_attention_plain(q[:, :1], k, k, kv_len=kl))
    la = -torch.from_numpy(np.abs(rng.standard_normal((1, 2, 32, 4))).astype(np.float32))
    C, Bm = (torch.from_numpy(rng.standard_normal((1, 2, 32, 16)).astype(np.float32))
             for _ in range(2))
    xs = torch.from_numpy(rng.standard_normal((1, 2, 32, 4, 16)).astype(np.float32))
    for got, want in zip(tops.ssd_intra_chunk(la, C, Bm, xs),
                         ssd_intra_chunk_plain(la, C, Bm, xs)):
        assert torch.equal(got, want)
    assert tops.LAUNCHES == {"rmsnorm": 0, "flash_attention": 0, "decode_attention": 0,
                             "ssd_intra_chunk": 0}


def test_ops_refuse_other_devices():
    x = torch.ones(2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tops.rmsnorm(x, torch.ones(8, device="meta"))


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel launchers never take a CPU tensor (no silent plain path)."""
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_triton
    from repro_torch.kernels.ssd_scan import ssd_intra_chunk_cuda
    x = torch.ones(1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rmsnorm_triton(x, torch.ones(64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(x, x, x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        decode_attention_cuda(x[:, :1], x, x, kv_len=torch.tensor(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_intra_chunk_cuda(x, x, x, x[..., None])
