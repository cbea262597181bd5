"""The port's training slice against repro's, on the smoke configs, from
repro's own ``init(PRNGKey(0))`` weights (and train state) carried across
with ``repro_torch.convert``: the loss and every grad leaf on qwen3-14b
(qk-norm), phi4-mini-3.8b and qwen2.5-32b (QKV bias); remat; the loss's
ignore_index; the bf16-cotangent norm; the 5-step trajectory of
``make_train_step`` (plain, accum 2, int8 compression) against repro's
jitted one; the train driver on the CPU; the plain backward versions of the
kernels against autograd; train-state checkpoints with their drain; the data
copy against repro's."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from tests.conftest import JAX_DRIFT_REASON, jax_api_drifted

pytestmark = pytest.mark.skipif(jax_api_drifted(), reason=JAX_DRIFT_REASON)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import runtime as jruntime  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.layers import cross_entropy_loss as jax_ce  # noqa: E402
from repro.models.layers import rmsnorm_bf16bwd as jax_rmsnorm_bf16bwd  # noqa: E402
from repro_torch import optim, runtime  # noqa: E402
from repro_torch.convert import train_state_from_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_plain,
    flash_attention_lse_plain,
    flash_attention_plain,
)
from repro_torch.kernels.rmsnorm import rmsnorm_bwd_plain, rmsnorm_plain  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import cross_entropy_loss, rmsnorm_bf16bwd  # noqa: E402
from tests import torch_train_parity as par  # noqa: E402

B, S = 2, 24
ARCHS = ["qwen3-14b", "phi4-mini-3.8b", "qwen2.5-32b"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return par.make_pair(get_smoke(request.param))


def test_loss_matches_repro(pair):
    par.check_loss(pair, par.make_batch(pair[0], B, S), use_kernels=False)


def test_grads_match_jax_grad(pair):
    """Every leaf within 1e-4 of its max|g| of jax.grad on repro's plain path."""
    par.check_grads(pair, par.make_batch(pair[0], B, S))


def test_remat_full_gives_the_same_grads(pair):
    par.check_remat(pair, par.make_batch(pair[0], B, S))


def test_cross_entropy_ignore_index_matches_repro():
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((2, 5, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 40, (2, 5)).astype(np.int32)
    labels[0, 1] = labels[1, 4] = labels[1, 0] = -100
    want = float(jax_ce(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels).long()))
    assert got == pytest.approx(want, rel=1e-6)
    all_ignored = torch.full((2, 5), -100)
    assert float(cross_entropy_loss(torch.from_numpy(logits), all_ignored)) == 0.0


def test_rmsnorm_bf16bwd_matches_autodiff_and_repro():
    """As tests/test_variants.py:49: the custom backward agrees with autograd
    through the plain norm, and dx keeps the input dtype (bf16)."""
    x = np.random.default_rng(12).standard_normal((2, 32, 64)).astype(np.float32)
    s = (1 + 0.1 * np.random.default_rng(13).standard_normal(64)).astype(np.float32)
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    ts = torch.from_numpy(s).bfloat16().requires_grad_()
    (rmsnorm_bf16bwd(ts, tx).float() ** 2).sum().backward()
    assert tx.grad.dtype == torch.bfloat16 and ts.grad.dtype == torch.bfloat16
    rx, rs = tx.detach().clone().requires_grad_(), ts.detach().clone().requires_grad_()
    (rmsnorm_plain(rx, rs).float() ** 2).sum().backward()
    for a, b in ((tx.grad, rx.grad), (ts.grad, rs.grad)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=5e-2, rtol=5e-2)
    jg = jax.grad(lambda s_, x_: (jax_rmsnorm_bf16bwd(s_, x_).astype(jnp.float32) ** 2).sum(),
                  argnums=(0, 1))(jnp.asarray(s, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16))
    for a, b in ((ts.grad, jg[0]), (tx.grad, jg[1])):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("variant", ["plain", "accum2", "compress"])
def test_five_step_trajectory_matches_repro(variant):
    """From the same train state and batch, the port's ``make_train_step``
    follows repro's jitted one within 2e-3 relative at every step, and the
    loss falls."""
    cfg = get_smoke("phi4-mini-3.8b")
    kw = {"plain": dict(remat=None), "accum2": dict(remat="full", accum=2),
          "compress": dict(remat=None, compress_grads=True)}[variant]
    par.check_trajectory(cfg, par.make_batch(cfg, B, S, seed=21), **kw)


def test_train_state_converts_leaf_for_leaf():
    cfg = get_smoke("phi4-mini-3.8b")
    jrt = jruntime.RuntimeConfig(compress_grads=True)
    jstate = jruntime.make_train_state(jax_build_model(cfg), jax.random.PRNGKey(0), jrt)
    tstate = train_state_from_numpy(par.np_tree(jstate), dtype=torch.bfloat16)
    assert tstate.opt.step.dtype == torch.int32 and int(tstate.opt.step) == 0
    assert tstate.params["embed"]["w"].dtype == torch.bfloat16
    for got, want in ((tstate.opt.master, jstate.opt.master), (tstate.ef.residual,
                                                                jstate.ef.residual)):
        g, w = par.flat(got), par.flat(par.np_tree(want))
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == torch.float32
            np.testing.assert_array_equal(g[k].numpy(), w[k])


def test_train_driver_on_cpu():
    """The port of tests/test_system.py:159 on the dense phi4-mini: the corpus
    staged into the burst tier, checkpoints drained, the held batch improved."""
    from repro_torch.launch.train import main
    res = main(["--arch", "phi4-mini-3.8b", "--steps", "6", "--batch", "2", "--seq", "32",
                "--ckpt-every", "3", "--device", "cpu"])
    assert res["improved"]
    assert res["steps"] == [3, 6]
    assert len(res["drains"]) == 2 and all(d["files"] > 0 for d in res["drains"])
    assert len(res["losses"]) == 6 and all(np.isfinite(res["losses"]))


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("S_,G,hd", [(13, 1, 16), (20, 3, 16), (40, 2, 256)])
def test_flash_bwd_plain_equals_autograd(S_, G, hd, window):
    """The explicit dS = P * (dP - D) form against autograd through the plain
    forward, float32, GQA and a window; lse against logsumexp; at gemma3's
    head dim 256 too."""
    rng = np.random.default_rng(14)
    shapes = ((2, S_, 2 * G, hd), (2, S_, 2, hd), (2, S_, 2, hd), (2, S_, 2 * G, hd))
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes)
    leaves_ = [t.clone().requires_grad_() for t in (q, k, v)]
    o = flash_attention_plain(*leaves_, window=window)
    o.backward(do)
    lse = flash_attention_lse_plain(q, k, window=window)
    got = flash_attention_bwd_plain(q, k, v, o.detach(), lse, do, window=window)
    for g, t in zip(got, leaves_):
        torch.testing.assert_close(g, t.grad, atol=2e-6, rtol=1e-5)


def test_rmsnorm_bwd_plain_equals_autograd():
    rng = np.random.default_rng(15)
    x, g = (torch.from_numpy(rng.standard_normal((3, 7, 128)).astype(np.float32))
            for _ in range(2))
    s = torch.from_numpy(rng.standard_normal(128).astype(np.float32))
    xl, sl = x.clone().requires_grad_(), s.clone().requires_grad_()
    rmsnorm_plain(xl, sl).backward(g)
    dx, ds = rmsnorm_bwd_plain(x, s, g)
    torch.testing.assert_close(dx, xl.grad, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(ds, sl.grad, atol=1e-5, rtol=1e-5)


def test_train_state_checkpoint_round_trip_and_drain():
    """{"params", "opt"} with the OptState NamedTuple: saved to a burst tier,
    drained (sync and in the background) to the global FS, restored exactly."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import _flatten_with_paths
    from repro_torch.core import GlobalFS
    cfg = dataclasses.replace(get_smoke("phi4-mini-3.8b"), n_layers=2, dtype="bfloat16")
    state = runtime.make_train_state(build_model(cfg), torch.Generator().manual_seed(0),
                                     runtime.RuntimeConfig())
    state.opt.m["embed"]["w"].normal_()
    tree = {"params": state.params, "opt": state.opt._replace(step=torch.tensor(
        7, dtype=torch.int32))}
    burst, gfs = GlobalFS(), GlobalFS()
    mgr = CheckpointManager(burst, global_fs=gfs)
    man = mgr.save(7, tree)
    keys = [m["key"] for m in man["leaves"]]
    assert "opt/step" in keys and "opt/master/layers/attn/wq/w" in keys
    assert keys.index("opt/step") < keys.index("opt/master/embed/w")     # field order
    rep = mgr.drain_to_global(7)
    assert rep["files"] == len(keys) + 1 and gfs.exists("/persist/ckpt/step-00000007/COMMIT")
    mgr.save(8, tree)
    mgr.drain_async(8)
    mgr.wait_drains()
    assert gfs.exists("/persist/ckpt/step-00000008/COMMIT")
    restored, step = mgr.restore(tree)
    assert step == 8 and isinstance(restored["opt"], optim.OptState)
    got, want = _flatten_with_paths(restored), _flatten_with_paths(tree)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    burst.teardown()
    gfs.teardown()


def test_data_copy_matches_repro():
    from repro.core import GlobalFS as JGlobalFS
    from repro.data import DatasetSpec as JSpec
    from repro.data import Loader as JLoader
    from repro.data import write_corpus as jwrite
    from repro_torch.core import GlobalFS
    from repro_torch.data import DatasetSpec, Loader, write_corpus
    spec, jspec = DatasetSpec(7, 512, 5000, 1024), JSpec(7, 512, 5000, 1024)
    fs, jfs = GlobalFS(), JGlobalFS()
    write_corpus(fs, "/d", spec)
    jwrite(jfs, "/d", jspec)
    for step in (0, 3, 40):
        pairs = ((Loader(spec, 4, 32, fs=fs, root="/d"), JLoader(jspec, 4, 32, fs=jfs, root="/d")),
                 (Loader(spec, 4, 32), JLoader(jspec, 4, 32)))
        for got, want in ((a.batch_at(step), b.batch_at(step)) for a, b in pairs):
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(got[k], want[k])
    fs.teardown()
    jfs.teardown()
