"""Training the port's gemma3 local/global pattern against repro's, on the
smoke gemma3-12b (6 layers: 2 blocks of 2 local layers, window 32, and 1
global; qk-norm; tied embeddings), from repro's own weights, with a
48-token batch longer than the window so that it bites: the loss with
repro's ``use_kernels`` off and on (Pallas flash attention in interpret
mode), every grad leaf against ``jax.grad`` (the tied embedding's from both
the embed and the unembed), remat, the 5-step trajectory, the train driver.
The hd-256 backward kernel on the card: tests/test_torch_cuda.py."""

import pytest

torch = pytest.importorskip("torch")

from tests.conftest import JAX_DRIFT_REASON, jax_api_drifted

pytestmark = pytest.mark.skipif(jax_api_drifted(), reason=JAX_DRIFT_REASON)

from repro.configs import get_smoke  # noqa: E402
from tests import torch_train_parity as par  # noqa: E402

ARCH = "gemma3-12b"
CFG = get_smoke(ARCH)
B, S = 2, 48
assert S > CFG.sliding_window and CFG.tie_embeddings


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
