"""The port's Mamba2 pieces against repro's: the SSD intra-chunk block's plain
version against the Pallas kernel (interpret mode) and the jnp oracle over
the sweep of tests/test_kernels.py (its device dispatch is checked in
tests/test_torch_kernels.py); the causal conv, the chunked scan (tail
padded, with and without an initial state, repro's ``use_kernel`` off and
on) and the mixer in both forms. The kernel against its plain version on a
CUDA card: tests/test_torch_cuda.py."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from tests.conftest import JAX_DRIFT_REASON, jax_api_drifted

pytestmark = pytest.mark.skipif(jax_api_drifted(), reason=JAX_DRIFT_REASON)

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke  # noqa: E402
from repro.models import mamba2 as jm  # noqa: E402
from repro_torch.kernels.causal_conv import causal_conv_plain  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd_intra_chunk_bwd_plain,
    ssd_intra_chunk_plain,
)
from repro_torch.models import mamba2 as tm  # noqa: E402

SWEEP = [(2, 4, 32, 8, 16, 16), (1, 2, 64, 4, 64, 64), (1, 1, 128, 2, 32, 64)]
TOL, TOL_TOT = 2e-4, 1e-5          # tests/test_kernels.py:81-83


def _ssd_inputs(seed, B, nc, Q, H, N, P, signed=False):
    """la = -|z| * 0.1, or z * 0.05 (some la > 0) where ``signed``."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, nc, Q, H))
    la = (z * 0.05 if signed else -np.abs(z) * 0.1).astype(np.float32)
    C, Bm = (rng.standard_normal((B, nc, Q, N)).astype(np.float32) for _ in range(2))
    x = rng.standard_normal((B, nc, Q, H, P)).astype(np.float32)
    return la, C, Bm, x


def _port(arrs):
    """The port's side of ``_ssd_inputs``: C and B in one group,
    (B, nc, Q, 1, N), where ``repro`` takes (B, nc, Q, N)."""
    la, C, Bm, *rest = (torch.from_numpy(a) for a in arrs)
    return (la, C[..., None, :], Bm[..., None, :], *rest)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,nc,Q,H,N,P", SWEEP)
def test_ssd_intra_chunk_plain_matches_pallas(B, nc, Q, H, N, P):
    from repro.kernels import ops, ref
    arrs = _ssd_inputs(2, B, nc, Q, H, N, P)
    got = ssd_intra_chunk_plain(*_port(arrs))
    jargs = [jnp.asarray(a) for a in arrs]
    for want in (ops.ssd_intra_chunk(*jargs), ref.ssd_intra_chunk_ref(*jargs)):
        for g, w, tol in zip(got, want, (TOL, TOL, TOL_TOT)):
            assert g.shape == w.shape and g.dtype == torch.float32
            _close(g, w, tol)


@pytest.mark.parametrize("B,nc,Q,H,N,P", SWEEP)
def test_ssd_intra_chunk_plain_matches_pallas_with_growth(B, nc, Q, H, N, P):
    """la > 0 in places: exp(L_t - L_s) > 1 is part of the function, and the
    plain version (what the CUDA kernel is held to) keeps it as repro does."""
    from repro.kernels import ops
    arrs = _ssd_inputs(4, B, nc, Q, H, N, P, signed=True)
    assert (arrs[0] > 0).any()
    got = ssd_intra_chunk_plain(*_port(arrs))
    want = ops.ssd_intra_chunk(*(jnp.asarray(a) for a in arrs))
    for g, w, tol in zip(got, want, (TOL, TOL, TOL_TOT)):
        _close(g, w, tol)


# Q 40 is no multiple of 16; la > 0 in places in the signed cases
BWD_SWEEP = [(s, False) for s in SWEEP] + [((1, 2, 40, 3, 4, 12), True),
                                           ((2, 1, 24, 2, 8, 4), False)]


@pytest.mark.parametrize("shape,signed", BWD_SWEEP)
def test_ssd_intra_chunk_bwd_plain_matches_jax_grad(shape, signed):
    """The backward's plain version (what the CUDA backward kernel is held
    to) against jax.grad through repro's jnp oracle, for dy, dstates and a
    nonzero dtot: each gradient within 1e-5 of its max."""
    import jax

    from repro.kernels import ref
    arrs = _ssd_inputs(6, *shape, signed=signed)
    y, st, tot = ssd_intra_chunk_plain(*_port(arrs))
    rng = np.random.default_rng(7)
    cots = [rng.standard_normal(t.shape).astype(np.float32) for t in (y, st, tot)]
    assert np.abs(cots[2]).min() > 0

    def f(*ins):
        outs = ref.ssd_intra_chunk_ref(*ins)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots))
    want = jax.grad(f, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in arrs))
    dla, dC, dB, dx = ssd_intra_chunk_bwd_plain(*_port((*arrs, *cots)))
    for g, w in zip((dla, dC[..., 0, :], dB[..., 0, :], dx), want):
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape and g.dtype == torch.float32
        assert np.max(np.abs(g.numpy() - w)) / np.max(np.abs(w)) < 1e-5


# -- the mixer -------------------------------------------------------------------
def test_causal_conv_matches_repro():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 13, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32)
    want = jm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = causal_conv_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    assert got.is_contiguous()
    _close(got, want, 1e-5)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_repro(use_kernel, with_h0):
    """S = 40 with Q = 32: the tail is padded with identity steps."""
    rng = np.random.default_rng(5)
    Bsz, S, H, P, N, Q = 2, 40, 4, 16, 16, 32
    x = rng.standard_normal((Bsz, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bsz, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal((H,)) * 0.5).astype(np.float32)
    Bm, C = (rng.standard_normal((Bsz, S, N)).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((Bsz, H, P, N)).astype(np.float32) if with_h0 else None
    jy, jh = jm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, C)), Q,
                            None if h0 is None else jnp.asarray(h0), use_kernel=use_kernel)
    # the port's C and B in one group, (B, S, 1, N)
    ty, th = tm.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, Bm[:, :, None],
                                                            C[:, :, None])),
                            Q, None if h0 is None else torch.from_numpy(h0))
    assert ty.shape == (Bsz, S, H, P) and th.shape == (Bsz, H, P, N)
    _close(ty, jy, TOL)
    _close(th, jh, TOL)


@pytest.fixture(scope="module")
def mixer():
    import jax
    from repro_torch.convert import from_numpy
    cfg = get_smoke("zamba2-7b")
    jp = jm.mamba_init(jax.random.PRNGKey(0), cfg)
    # non-trivial dt_bias / A_log / D so every term of the mixer counts
    rng = np.random.default_rng(6)
    H = cfg.n_ssm_heads
    jp = dict(jp, dt_bias=jnp.asarray(rng.standard_normal(H), jnp.float32),
              A_log=jnp.asarray(rng.standard_normal(H) * 0.5, jnp.float32),
              D=jnp.asarray(rng.standard_normal(H), jnp.float32))
    tp = from_numpy(jax.tree.map(np.asarray, jp))
    return cfg, jp, tp


def test_mamba_forward_prefill_matches_repro(mixer):
    cfg, jp, tp = mixer
    x = np.random.default_rng(7).standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    want, _ = jm.mamba_forward(jp, jnp.asarray(x), cfg)
    got, state = tm.mamba_forward(tp, torch.from_numpy(x), cfg)
    _close(got, want, TOL)
    W = cfg.ssm_conv_width
    assert state.conv.shape == (2, W - 1, cfg.d_inner_ssm + 2 * cfg.ssm_state)
    assert state.h.shape == (2, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)


def test_mamba_forward_decode_matches_repro(mixer):
    """Three recurrent steps from a random state; the port updates its cache
    in place and must hold what repro returns."""
    cfg, jp, tp = mixer
    rng = np.random.default_rng(8)
    conv = rng.standard_normal((2, cfg.ssm_conv_width - 1,
                                cfg.d_inner_ssm + 2 * cfg.ssm_state)).astype(np.float32)
    h = rng.standard_normal((2, cfg.n_ssm_heads, cfg.ssm_head_dim,
                             cfg.ssm_state)).astype(np.float32)
    jc = jm.MambaCache(jnp.asarray(conv), jnp.asarray(h))
    tc = tm.MambaCache(torch.from_numpy(conv.copy()), torch.from_numpy(h.copy()))
    for _ in range(3):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, jc = jm.mamba_forward(jp, jnp.asarray(x), cfg, cache=jc)
        got, out = tm.mamba_forward(tp, torch.from_numpy(x), cfg, cache=tc)
        assert out.conv is tc.conv and out.h is tc.h
        _close(got, want, TOL)
        _close(tc.conv, jc.conv, 1e-6)
        _close(tc.h, jc.h, TOL)
