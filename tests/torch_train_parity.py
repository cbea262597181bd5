"""Checks shared by the port's training parity tests: the port against
repro on a smoke config, from repro's own ``init(PRNGKey(0))`` weights (and
train state) carried across with ``repro_torch.convert``. Imported by the
``tests/test_torch_train*.py`` files."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro import runtime as jruntime
from repro.models import build_model as jax_build_model
from repro_torch import optim, runtime
from repro_torch.convert import from_numpy, train_state_from_numpy
from repro_torch.models import build_model
from repro_torch.optim.adamw import leaves

LOSS_TOL = 1e-4         # tests/test_models.py:100
GRAD_TOL = 1e-4         # of each leaf's max|g|
TRAJ_TOL = 2e-3         # relative, tests/test_distributed.py:60


def np_tree(tree):
    """repro arrays -> numpy, bf16 widened to float32, ints kept."""
    return jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
                        else np.asarray(a), tree)


def make_batch(cfg, B: int, S: int, seed: int = 3) -> dict:
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def torch_batch(batch: dict) -> dict:
    """Token arrays as int64 tensors, float arrays (frames) as they are."""
    return {k: torch.from_numpy(v).long() if np.issubdtype(v.dtype, np.integer)
            else torch.from_numpy(v) for k, v in batch.items()}


def jax_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{pre}{k}/"))
        return out
    return {pre.rstrip("/"): tree}


def port_grads(model, params, batch, remat=None):
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    loss, _ = model.loss(params, batch, remat=remat)
    grads = torch.autograd.grad(loss, ps)
    for p in ps:
        p.requires_grad_(False)
    return float(loss.detach()), grads


def make_pair(cfg):
    jmodel = jax_build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return cfg, jmodel, jparams, build_model(cfg), from_numpy(np_tree(jparams))


def check_loss(pair, batch, use_kernels: bool) -> None:
    """The loss within 1e-4 of repro's, its kernel path (Pallas in interpret
    mode) on or off; the metrics as the dense family's."""
    cfg, jmodel, jparams, tmodel, tparams = pair
    jl, _ = jmodel.loss(jparams, jax_batch(batch), use_kernels=use_kernels)
    with torch.no_grad():
        tl, tm = tmodel.loss(tparams, torch_batch(batch))
    assert abs(float(tl) - float(jl)) < LOSS_TOL
    assert float(tm["ce"]) == float(tl) and float(tm["aux"]) == 0.0


def check_grads(pair, batch) -> None:
    """Every leaf within 1e-4 of its max|g| of jax.grad on repro's plain path."""
    cfg, jmodel, jparams, tmodel, tparams = pair
    jg = jax.grad(lambda p: jmodel.loss(p, jax_batch(batch))[0])(jparams)
    _, tg = port_grads(tmodel, tparams, torch_batch(batch))
    jflat = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(g)
             for path, g in jax.tree_util.tree_flatten_with_path(jg)[0]}
    tflat = dict(zip(sorted(flat(tparams)), tg))
    assert tflat.keys() == jflat.keys()
    for key, want in jflat.items():
        got = tflat[key].numpy()
        assert got.shape == want.shape
        scale = np.max(np.abs(want)) + 1e-12
        assert np.max(np.abs(got - want)) / scale < GRAD_TOL, key


def check_remat(pair, batch) -> None:
    """remat "full" (and "dots", taken as "full") gives the grads of no remat."""
    cfg, _, _, tmodel, tparams = pair
    tb = torch_batch(batch)
    l0, g0 = port_grads(tmodel, tparams, tb, remat=None)
    l1, g1 = port_grads(tmodel, tparams, tb, remat="full")
    l2, g2 = port_grads(tmodel, tparams, tb, remat="dots")
    assert l0 == l1 == l2
    for a, b, c in zip(g0, g1, g2):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)
        torch.testing.assert_close(a, c, atol=1e-7, rtol=1e-6)


def check_trajectory(cfg, batch, remat=None, **kw) -> None:
    """From the same train state and batch, the port's ``make_train_step``
    follows repro's jitted one within 2e-3 relative at every step (loss and
    grad norm), and the loss falls. ``kw`` goes to both ``RuntimeConfig``s
    (accumulation, compression)."""
    opt_kw = dict(lr=1e-3)
    jrt = jruntime.RuntimeConfig(zero1=False, schedule="constant", remat=remat,
                                 opt=joptim.AdamWConfig(**opt_kw), **kw)
    trt = runtime.RuntimeConfig(schedule="constant", remat=remat,
                                opt=optim.AdamWConfig(**opt_kw), **kw)
    jmodel = jax_build_model(cfg)
    jstate = jruntime.make_train_state(jmodel, jax.random.PRNGKey(0), jrt)
    tstate = train_state_from_numpy(np_tree(jstate))
    jstep = jax.jit(jruntime.make_train_step(jmodel, jrt))
    tstep = runtime.make_train_step(build_model(cfg), trt)
    jb, tb = jax_batch(batch), torch_batch(batch)
    jl, tl = [], []
    for _ in range(5):
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=TRAJ_TOL)
    np.testing.assert_allclose(tl, jl, rtol=TRAJ_TOL)
    assert tl[-1] < tl[0]
    assert int(tstate.opt.step) == 5
    assert all(bool(torch.isfinite(p).all()) for p in leaves(tstate.params))


def check_train_driver(arch: str) -> None:
    """``launch.train`` on the CPU: the corpus staged into the burst tier,
    checkpoints drained, the held batch improved."""
    from repro_torch.launch.train import main
    res = main(["--arch", arch, "--steps", "6", "--batch", "2", "--seq", "48",
                "--ckpt-every", "3", "--device", "cpu"])
    assert res["improved"]
    assert res["steps"] == [3, 6]
    assert len(res["drains"]) == 2 and all(d["files"] > 0 for d in res["drains"])
    assert len(res["losses"]) == 6 and all(np.isfinite(res["losses"]))
