"""The port's MoE family against repro's, on the smoke qwen3-moe-30b-a3b and
granite-moe-1b-a400m, from repro's own ``init(PRNGKey(0))`` weights (and
train state) carried across with ``repro_torch.convert``: the dispatch plan
slot for slot (with and without drops), one MoE FFN (y and aux), the routing
fed to both sides' dispatch/experts/combine, the loss, aux and every grad
leaf, prefill and decode logits, the capacity-0.25 drop case, remat, the
float32 router leaf, the 5-step granite trajectory, the train and serve
drivers on the CPU with the MoE archs, and ``moe.observe``, the hook that
the comparison runs and the profiler watch the MoE layers through.

Routing: both sides pick the top k of the same float32 probabilities, so a
route can differ only where the k-th and (k+1)-th probability are within
rounding of each other. The model-level tests below hold every route of the
fixed seeds' inputs: they check that all (layer, token) routes agree before
comparing outputs, and say which routes they compared.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from tests.conftest import JAX_DRIFT_REASON, jax_api_drifted

pytestmark = pytest.mark.skipif(jax_api_drifted(), reason=JAX_DRIFT_REASON)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import runtime as jruntime  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import optim, runtime, spans  # noqa: E402
from repro_torch.convert import from_numpy, train_state_from_numpy  # noqa: E402
from repro_torch.models import build_model, moe  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402

B, S = 2, 24
LOSS_TOL = 1e-4          # tests/test_models.py:100
GRAD_TOL = 1e-4          # of each leaf's max|g|
FFN_TOL = 2e-5           # y and aux of one MoE FFN, float32
TRAJ_TOL = 2e-3          # relative, tests/test_distributed.py:60
ARCHS = ["qwen3-moe-30b-a3b", "granite-moe-1b-a400m"]


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
                        else np.asarray(a), tree)


def _batch(cfg, seed=3, seq=S):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, seq + 1))
    toks = toks.astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}{k}/"))
        return out
    return {pre.rstrip("/"): tree}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _port_grads(model, params, batch, remat=None):
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss, metrics = model.loss(params, batch, remat=remat)
    grads = torch.autograd.grad(loss, flat)
    for p in flat:
        p.requires_grad_(False)
    return float(loss.detach()), float(metrics["aux"].detach()), grads


class _RouteLog:
    """A ``moe.observe`` routing hook that records the input and the expert
    ids of every ``moe.route`` call (ids sorted per token: the order inside
    the top k does not change the dispatch)."""

    def __init__(self):
        self.inputs, self.ids = [], []

    def __call__(self, p, x, logits, probs, w, idx):
        self.inputs.append(x.detach().numpy().copy())
        self.ids.append(torch.sort(idx, dim=-1).values.numpy())
        return w, idx


def _jax_routes(jparams, cfg, x_in):
    """repro's top-k ids for one layer input (numpy (B, S, d)), sorted per token."""
    logits = jnp.asarray(x_in) @ jparams["router"]["w"]
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.experts_per_token)
    return np.sort(np.asarray(idx), axis=-1)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    cfg = get_smoke(request.param)
    jmodel = jax_build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return cfg, jmodel, jparams, build_model(cfg), from_numpy(_np(jparams))


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def _torch_layer(tparams, i):
    """Layer ``i``'s MoE params of the port's stacked tree."""
    m = tparams["layers"]["moe"]
    return {"router": {"w": m["router"]["w"][i]}, **{k: m[k][i] for k in ("gate", "up", "down")}}


# -- dispatch -------------------------------------------------------------------
@pytest.mark.parametrize("case", ["room", "drops", "skewed"])
def test_dispatch_plan_matches_repro(case):
    """Slot of every dispatch and the buffer, integer for integer, against
    repro's ``_dispatch_row`` row by row; with C from capacity factor 8
    (room), 0.25 (drops), and 1.25 with ids crowded onto two experts (drops)."""
    E, S_, k, d = 8, 40, 2, 5
    rng = np.random.default_rng({"room": 0, "drops": 1, "skewed": 2}[case])
    idx = np.stack([np.stack([rng.choice(E, k, replace=False) for _ in range(S_)])
                    for _ in range(3)])
    if case == "skewed":
        idx[:, ::2] = [1, 6]
    cf = {"room": 8.0, "drops": 0.25, "skewed": 1.25}[case]
    C = max(1, int(-(-S_ * k * cf // E)))
    x = rng.standard_normal((3, S_, d)).astype(np.float32)
    slot_tok, slots = moe.dispatch_plan(torch.from_numpy(idx), E, C)
    dropped = 0
    for r in range(3):
        buf, want = jmoe._dispatch_row(jnp.asarray(x[r]), jnp.asarray(idx[r], jnp.int32), E, C)
        np.testing.assert_array_equal(slots[r].numpy(), np.asarray(want))
        x_pad = np.concatenate([x[r], np.zeros((1, d), np.float32)])
        np.testing.assert_array_equal(x_pad[slot_tok[r].numpy()].reshape(E, C, d),
                                      np.asarray(buf))
        dropped += int((np.asarray(want) == E * C).sum())
    assert (dropped > 0) == (case != "room")


def test_moe_ffn_matches_repro(pair):
    """y and aux of layer 0's FFN on the same input, within 2e-5."""
    cfg, _, jparams, _, tparams = pair
    x = np.random.default_rng(5).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_ffn(_layer(jparams["layers"]["moe"], 0), jnp.asarray(x), cfg)
    ty, taux = moe.moe_ffn(_torch_layer(tparams, 0), torch.from_numpy(x), cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=FFN_TOL, rtol=FFN_TOL)
    assert float(taux) == pytest.approx(float(jaux), rel=FFN_TOL)
    assert float(taux) >= 1.0 - 1e-6


def test_experts_take_the_given_routing(pair):
    """The dispatch/experts/combine half fed repro's own (w, idx) gives
    repro's y: the two halves can be held apart."""
    cfg, _, jparams, _, tparams = pair
    x = np.random.default_rng(6).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jp = _layer(jparams["layers"]["moe"], 1)
    jy, _ = jmoe.moe_ffn(jp, jnp.asarray(x), cfg)
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"]["w"], axis=-1)
    w, idx = jax.lax.top_k(probs, cfg.experts_per_token)
    w = w / jnp.maximum(w.sum(-1, keepdims=True), 1e-9)
    tp = _torch_layer(tparams, 1)
    logits, _, _, _ = moe.route(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jnp.asarray(x) @ jp["router"]["w"]),
                               atol=1e-5, rtol=1e-5)
    ty = moe.experts(tp, torch.from_numpy(x), torch.from_numpy(np.array(w)),
                     torch.from_numpy(np.array(idx)).long(), cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=FFN_TOL, rtol=FFN_TOL)


# -- model ------------------------------------------------------------------------
def test_loss_and_aux_match_repro(pair):
    """Every (layer, token) route of this batch agrees with repro's (checked
    on the port's layer inputs), then loss within 1e-4 and aux within 2e-5."""
    cfg, jmodel, jparams, tmodel, tparams = pair
    batch = _batch(cfg)
    jl, jm = jmodel.loss(jparams, _jb(batch))
    log = _RouteLog()
    with torch.no_grad(), moe.observe(route_hook=log):
        tl, tm = tmodel.loss(tparams, _tb(batch))
    assert len(log.ids) == cfg.n_layers
    for i, (ids, x_in) in enumerate(zip(log.ids, log.inputs)):
        want = _jax_routes(_layer(jparams["layers"]["moe"], i), cfg, x_in)
        np.testing.assert_array_equal(ids, want)
    assert abs(float(tl) - float(jl)) < LOSS_TOL
    assert float(tm["aux"]) == pytest.approx(float(jm["aux"]), rel=FFN_TOL)
    assert float(tl) == pytest.approx(float(tm["ce"]) + 0.01 * float(tm["aux"]), rel=1e-6)


def test_grads_match_jax_grad(pair):
    """Every leaf, the float32 router included, within 1e-4 of its max|g| of
    jax.grad on repro's path (routes as checked by the loss test)."""
    cfg, jmodel, jparams, tmodel, tparams = pair
    batch = _batch(cfg)
    jg = jax.grad(lambda p: jmodel.loss(p, _jb(batch))[0])(jparams)
    _, _, tg = _port_grads(tmodel, tparams, _tb(batch))
    jflat = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(g)
             for path, g in jax.tree_util.tree_flatten_with_path(jg)[0]}
    tflat = dict(zip(sorted(_flat(tparams)), tg))
    assert tflat.keys() == jflat.keys()
    assert "layers/moe/router/w" in jflat
    for key, want in jflat.items():
        got = tflat[key].numpy()
        assert got.shape == want.shape
        assert np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12) < GRAD_TOL, key


def test_prefill_and_decode_logits_match_repro(pair):
    """Prefill, then 4 decode steps, logits within 1e-4 of max|logit|; the
    decode steps against the port's own full forward within 2e-2
    (tests/test_models.py:73-89, capacity 8 so that nothing is dropped)."""
    cfg, jmodel, jparams, tmodel, tparams = pair
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S + 4)).astype(np.int32)
    S_max = S + 4
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])}, S_max)
    tl, tcache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :S]).long()},
                                S_max)
    assert _rel(tl, jl) < LOSS_TOL
    for t in range(4):
        tok = toks[:, S + t]
        jl, jcache = jmodel.decode_step(jparams, jcache, {"token": jnp.asarray(tok)})
        tl, tcache = tmodel.decode_step(tparams, tcache, {"token": torch.from_numpy(tok).long()})
        assert _rel(tl, jl) < LOSS_TOL
    assert int(tcache["pos"]) == S + 4

    wide = dataclasses.replace(cfg, moe_capacity_factor=8.0)
    model = build_model(wide)
    t = torch.from_numpy(toks).long()
    _, cache = model.prefill(tparams, {"tokens": t[:, :S]}, S_max)
    for i in range(4):
        logits, cache = model.decode_step(tparams, cache, {"token": t[:, S + i]})
    full, _ = model.prefill(tparams, {"tokens": t}, S_max)
    assert _rel(logits, full) < 2e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_match_repro(arch):
    """Capacity factor 0.25 (tests/test_models.py:122): tokens are dropped,
    the loss is finite and equal to repro's, and aux >= 1 (:131)."""
    cfg = dataclasses.replace(get_smoke(arch), moe_capacity_factor=0.25)
    jmodel = jax_build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = _batch(cfg)
    jl, jm = jmodel.loss(jparams, _jb(batch))
    with torch.no_grad():
        tl, tm = build_model(cfg).loss(from_numpy(_np(jparams)), _tb(batch))
    assert moe._capacity(S, cfg) * cfg.n_experts < S * cfg.experts_per_token
    assert np.isfinite(float(tl))
    assert abs(float(tl) - float(jl)) < LOSS_TOL
    assert float(tm["aux"]) == pytest.approx(float(jm["aux"]), rel=FFN_TOL)
    assert float(tm["aux"]) >= 1.0


def test_remat_recomputes_the_same_routing(pair):
    """Under remat "full" each layer's routing runs again in the backward and
    picks the same experts; loss and grads equal those without remat."""
    cfg, _, _, tmodel, tparams = pair
    batch = _tb(_batch(cfg))
    l0, a0, g0 = _port_grads(tmodel, tparams, batch)
    log = _RouteLog()
    with moe.observe(route_hook=log):
        l1, a1, g1 = _port_grads(tmodel, tparams, batch, remat="full")
    L = cfg.n_layers
    assert len(log.ids) == 2 * L                       # forward, then recomputed in reverse
    for i in range(L):
        np.testing.assert_array_equal(log.ids[i], log.ids[2 * L - 1 - i])
    assert l0 == l1 and a0 == a1
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


def test_router_leaf_stays_float32_in_bf16():
    cfg = dataclasses.replace(get_smoke("qwen3-moe-30b-a3b"), dtype="bfloat16")
    jparams = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    assert jparams["layers"]["moe"]["router"]["w"].dtype == jnp.float32
    tparams = from_numpy(_np(jparams), dtype=torch.bfloat16)
    flat = _flat(tparams)
    assert flat["layers/moe/router/w"].dtype == torch.float32
    assert flat["layers/moe/gate"].dtype == torch.bfloat16
    assert flat["layers/attn/wq/w"].dtype == torch.bfloat16
    own = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert {k: v.dtype for k, v in _flat(own).items()} == {k: v.dtype for k, v in flat.items()}
    state = train_state_from_numpy(
        _np(jruntime.make_train_state(jax_build_model(cfg), jax.random.PRNGKey(0),
                                      jruntime.RuntimeConfig())), dtype=torch.bfloat16)
    assert state.params["layers"]["moe"]["router"]["w"].dtype == torch.float32
    assert state.opt.master["layers"]["moe"]["gate"].dtype == torch.float32


def test_bf16_loss_close_to_repro():
    """The published dtype: bf16 weights and activations, router float32,
    loss within the bf16 tolerance."""
    cfg = dataclasses.replace(get_smoke("granite-moe-1b-a400m"), dtype="bfloat16")
    jmodel = jax_build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = _batch(cfg)
    jl, _ = jmodel.loss(jparams, _jb(batch))
    with torch.no_grad():
        tl, _ = build_model(cfg).loss(from_numpy(_np(jparams), dtype=torch.bfloat16),
                                      _tb(batch))
    assert abs(float(tl) - float(jl)) / abs(float(jl)) < 2e-2


# -- training -----------------------------------------------------------------------
def test_five_step_granite_trajectory_matches_repro():
    """The train driver's default arch: from the same train state and batch,
    the port's ``make_train_step`` follows repro's jitted one within 2e-3
    relative at every step (loss, aux and grad norm), and the loss falls."""
    cfg = get_smoke("granite-moe-1b-a400m")
    opt_kw = dict(lr=1e-3)
    jrt = jruntime.RuntimeConfig(zero1=False, schedule="constant", remat=None,
                                 opt=joptim.AdamWConfig(**opt_kw))
    trt = runtime.RuntimeConfig(schedule="constant", remat=None, opt=optim.AdamWConfig(**opt_kw))
    jmodel = jax_build_model(cfg)
    jstate = jruntime.make_train_state(jmodel, jax.random.PRNGKey(0), jrt)
    tstate = train_state_from_numpy(_np(jstate))
    jstep = jax.jit(jruntime.make_train_step(jmodel, jrt))
    tstep = runtime.make_train_step(build_model(cfg), trt)
    batch = _batch(cfg, seed=21)
    jl, tl = [], []
    for _ in range(5):
        jstate, jm = jstep(jstate, _jb(batch))
        tstate, tm = tstep(tstate, _tb(batch))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        assert float(tm["aux"]) == pytest.approx(float(jm["aux"]), rel=TRAJ_TOL)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=TRAJ_TOL)
    np.testing.assert_allclose(tl, jl, rtol=TRAJ_TOL)
    assert tl[-1] < tl[0]


def test_train_driver_default_arch_on_cpu():
    """``launch.train`` with no ``--arch``: repro's default, the MoE
    granite-moe-1b-a400m, staged, trained, checkpointed and improved."""
    from repro_torch.launch.train import main
    res = main(["--steps", "6", "--batch", "2", "--seq", "32", "--ckpt-every", "3",
                "--device", "cpu"])
    assert res["improved"]
    assert res["steps"] == [3, 6]
    assert len(res["drains"]) == 2
    assert len(res["losses"]) == 6 and all(np.isfinite(res["losses"]))


def test_serve_driver_moe_on_cpu():
    from repro_torch.launch.serve import main
    res = main(["--arch", "qwen3-moe-30b-a3b", "--requests", "3", "--prompt-len", "12",
                "--gen", "5", "--device", "cpu"])
    assert res["generated"] == (3, 5)
    assert res["stage_bytes"] == res["published_bytes"]


def test_profile_traces_ops_to_moe_functions():
    """``launch.profile``'s MoE breakdown records the program's spans
    (``spans.record(profiler=True)``) around the functions of ``models/moe.py``
    for its window only and finds, for the ops of a smoke
    prefill, the function that ran each (host activity here; on the card the
    same walk sums the kernels of those ops)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile import _moe_function
    cfg = get_smoke("qwen3-moe-30b-a3b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    with spans.record(profiler=True), profile(activities=[ProfilerActivity.CPU]) as prof:
        model.prefill(params, {"tokens": torch.randint(0, cfg.vocab_size, (2, 16))}, 20)
    assert spans.span("moe.route") is spans.OFF
    found = {_moe_function(e) for e in prof.events() if e.name.startswith("aten::")}
    assert found == {None, "route", "dispatch_plan", "experts", "load_balance_aux"}


def test_route_hook_sees_every_call_and_its_routing_is_used(pair):
    """``moe.observe``'s routing hook sees each layer's call through the
    model's own path (``transformer`` imports ``moe_ffn`` by name), a hook
    that returns the routing unchanged leaves the loss as it was, and one
    that replaces the expert ids changes the loss: the dispatch takes what
    the hook gives back."""
    cfg, _, _, tmodel, tparams = pair
    batch = _tb(_batch(cfg))
    with torch.no_grad():
        base, _ = tmodel.loss(tparams, batch)
        log = _RouteLog()
        with moe.observe(route_hook=log):
            same, _ = tmodel.loss(tparams, batch)

        def shifted(p, x, logits, probs, w, idx):
            return w, (idx + 1) % cfg.n_experts
        with moe.observe(route_hook=shifted):
            moved, _ = tmodel.loss(tparams, batch)
    assert len(log.ids) == cfg.n_layers
    assert float(same) == float(base)
    assert float(moved) != float(base)
    assert moe._ROUTE_HOOK is None


@pytest.mark.parametrize("exit_by", ["return", "error"])
def test_observe_is_off_outside_its_block(exit_by):
    """Outside ``moe.observe`` and ``spans.record`` no hook runs and no ``moe.*`` span is
    recorded, also after the block was left by an error."""
    from torch.profiler import ProfilerActivity, profile
    cfg = get_smoke("qwen3-moe-30b-a3b")
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((B, S, cfg.d_model), generator=torch.Generator().manual_seed(1))
    calls = []

    def hook(p, x, logits, probs, w, idx):
        calls.append(1)
        return w, idx
    try:
        with moe.observe(route_hook=hook), spans.record(profiler=True):
            moe.moe_ffn(p, x, cfg)
            if exit_by == "error":
                raise RuntimeError("left by an error")
    except RuntimeError:
        pass
    assert calls == [1]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        moe.moe_ffn(p, x, cfg)
    assert calls == [1]
    assert not [e.name for e in prof.events() if e.name.startswith("moe.")]
