"""Each hand-written kernel against its plain version on a CUDA card, at the
tolerances of tests/test_kernels.py, for the attention shapes of qwen3-14b
(GQA, hd 128) and zamba2-7b (MHA, hd 112), a sweep of head dims, group sizes,
lengths and windows over both attention kernels (bf16 runs the wgmma/TMA and
cp.async kernels, float32 the FMA kernels), and the SSD sweep. Every test here
carries the ``cuda`` marker and skips without a card. The file imports no JAX,
so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention_cuda, decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain
from repro_torch.kernels.rmsnorm import rmsnorm_plain
from repro_torch.kernels.ssd_scan import ssd_intra_chunk_plain

pytestmark = pytest.mark.cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SSD_TOLS = (2e-4, 2e-4, 1e-5)          # y, state, tot (tests/test_kernels.py:81-83)


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
