"""Training the port's Mamba2 hybrid against repro's, on the smoke zamba2-7b
(4 layers: 2 groups of 2 mamba layers and the shared block; chunk 32, so
the 48-token batch pads its second chunk), from repro's own weights: the
loss with repro's ``use_kernels`` off and on (the SSD intra-chunk Pallas
kernel in interpret mode), every grad leaf against ``jax.grad``, remat, the
5-step trajectory, the train driver; a hybrid train state converted leaf
for leaf (Mamba2's float32 leaves kept); the inter-chunk scan's gradient
with an initial state. The CUDA backward kernels on the card:
tests/test_torch_cuda.py."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from tests.conftest import JAX_DRIFT_REASON, jax_api_drifted

pytestmark = pytest.mark.skipif(jax_api_drifted(), reason=JAX_DRIFT_REASON)

import jax  # noqa: E402

from repro import runtime as jruntime  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.convert import train_state_from_numpy  # noqa: E402
from repro_torch.models import mamba2 as tm  # noqa: E402
from tests import torch_train_parity as par  # noqa: E402

ARCH = "zamba2-7b"
CFG = get_smoke(ARCH)
B, S = 2, 48


@pytest.fixture(scope="module")
def pair():
    return par.make_pair(CFG)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_loss_matches_repro(pair, use_kernels):
    par.check_loss(pair, par.make_batch(CFG, B, S), use_kernels)


def test_grads_match_jax_grad(pair):
    par.check_grads(pair, par.make_batch(CFG, B, S))


def test_remat_full_gives_the_same_grads(pair):
    par.check_remat(pair, par.make_batch(CFG, B, S))


def test_five_step_trajectory_matches_repro():
    par.check_trajectory(CFG, par.make_batch(CFG, B, S, seed=21))


def test_train_driver_on_cpu():
    par.check_train_driver(ARCH)


def test_train_state_converts_hybrid_leaves():
    """bf16 params with Mamba2's dt_bias, A_log and D kept float32, as
    repro's; the optimizer state float32 leaf for leaf."""
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    jstate = jruntime.make_train_state(jax_build_model(cfg), jax.random.PRNGKey(0),
                                       jruntime.RuntimeConfig())
    tstate = train_state_from_numpy(par.np_tree(jstate), dtype=torch.bfloat16)
    got, want = par.flat(tstate.params), par.flat(jstate.params)
    assert got.keys() == want.keys()
    for k, t in got.items():
        assert str(t.dtype).split(".")[-1] == str(want[k].dtype), k
    assert got["mamba_groups/mamba/A_log"].dtype == torch.float32
    for k, t in par.flat(tstate.opt.m).items():
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(par.flat(jstate.opt.m)[k]))


def test_ssd_chunked_grads_with_initial_state():
    """The chunked scan (tail padded, an initial state; float32 inside)
    against autograd through the step-by-step recurrence in float64: each
    gradient within 1e-5 of its max."""
    rng = np.random.default_rng(31)
    Bsz, S_, H, P, N, Q = 2, 37, 3, 4, 5, 8
    arrs = [rng.standard_normal(s) for s in ((Bsz, S_, H, P), (Bsz, S_, H), (Bsz, S_, 1, N),
                                            (Bsz, S_, 1, N), (Bsz, H, P, N))]
    x, dt_raw, Bm, Cm, h0 = (torch.from_numpy(a).requires_grad_() for a in arrs)
    A = -torch.tensor([0.5, 1.0, 2.0], dtype=torch.float64)
    dt = torch.nn.functional.softplus(dt_raw)
    y, hT = tm.ssd_chunked(x, dt, A, Bm, Cm, Q, h0=h0)
    (y.square().sum() + hT.sum()).backward()
    got = [t.grad.clone() for t in (x, dt_raw, Bm, Cm, h0)]
    for t in (x, dt_raw, Bm, Cm, h0):
        t.grad = None
    h, ys = h0, []
    dt = torch.nn.functional.softplus(dt_raw)
    for t in range(S_):
        a = torch.exp(dt[:, t] * A)
        h = a[..., None, None] * h + torch.einsum("bhp,bn->bhpn", dt[:, t, :, None] * x[:, t],
                                                  Bm[:, t, 0])
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t, 0], h))
    (torch.stack(ys, 1).square().sum() + h.sum()).backward()
    for g, t in zip(got, (x, dt_raw, Bm, Cm, h0)):
        assert float((g - t.grad).abs().max() / t.grad.abs().max()) < 1e-5
