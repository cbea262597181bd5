"""The port's optimizer (``repro_torch.optim``) against ``repro.optim``: one
AdamW update on identical grads leaf for leaf (clip active and inactive,
bf16 params with fp32 master), the cases of tests/test_optim.py, the
schedules, and int8 compression with error feedback over several steps.
Inputs come from numpy seeds and go to both sides."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from tests.conftest import JAX_DRIFT_REASON, jax_api_drifted

pytestmark = pytest.mark.skipif(jax_api_drifted(), reason=JAX_DRIFT_REASON)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.optim.compression import dequantize, quantize  # noqa: E402


def _tree(seed, dtype=np.float32, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((8, 16)) * scale).astype(dtype),
            "layers": {"a": (rng.standard_normal((3, 5)) * scale).astype(dtype),
                       "b": (rng.standard_normal((7,)) * scale).astype(dtype)}}


def _j(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _t(tree, dtype=torch.float32):
    return {k: _t(v, dtype) if isinstance(v, dict) else torch.from_numpy(np.array(v)).to(dtype)
            for k, v in tree.items()}


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}{k}/"))
        return out
    return {pre.rstrip("/"): np.asarray(tree.float() if isinstance(tree, torch.Tensor)
                                        else tree.astype(jnp.float32))}


def _assert_tree_close(got, want, rtol=1e-6, atol=1e-7):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in g:
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("clip", [0.05, 1e3], ids=["clip_active", "clip_inactive"])
@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
def test_adamw_update_matches_repro_leaf_for_leaf(clip, pdtype):
    """Three updates from identical state and grads: params, master, m, v,
    step, grad norm and lr agree; bf16 params keep fp32 master weights."""
    jdt, tdt = (jnp.float32, torch.float32) if pdtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    cfg_kw = dict(lr=1e-2, weight_decay=0.1, grad_clip=clip)
    params = _tree(0)
    jp, tp = _j(params, jdt), _t(params, tdt)
    jst, tst = joptim.init(jp), optim.init(tp)
    assert tst.master["w"].dtype == torch.float32 and tst.master["w"] is not tp["w"]
    for i in range(3):
        grads = _tree(10 + i, scale=0.3)
        lr_scale = 0.5 + 0.25 * i
        jp, jst, jstats = joptim.update(_j(grads), jst, jp, joptim.AdamWConfig(**cfg_kw),
                                        lr_scale=lr_scale)
        tp, tst, tstats = optim.update(_t(grads), tst, tp, optim.AdamWConfig(**cfg_kw),
                                       lr_scale=lr_scale)
        assert int(tst.step) == int(jst.step) == i + 1
        assert float(tstats["grad_norm"]) == pytest.approx(float(jstats["grad_norm"]), rel=1e-6)
        assert float(tstats["lr"]) == pytest.approx(float(jstats["lr"]), rel=1e-7)
        for got, want in ((tst.master, jst.master), (tst.m, jst.m), (tst.v, jst.v)):
            _assert_tree_close(got, want)
        assert tp["w"].dtype == tdt
        # bf16 params: the same fp32 master rounded, at most one bf16 ulp apart
        _assert_tree_close(tp, jp, rtol=1e-6 if pdtype == "float32" else 8e-3)


def _route_calls(monkeypatch, cuda: bool):
    """Record the plain versions that ``kernels.ops`` runs; with ``cuda``, the
    ops take CPU tensors for the card's (``_on_cuda`` True) and the Triton
    launchers are stood in for by the plain versions, so the kernel route's
    dispatch and counts run on the CPU."""
    from repro_torch.kernels import ops
    calls = []
    for name in ("adamw_plain", "grad_sumsq_plain"):
        def wrapped(*args, _plain=getattr(ops, name), _name=name, **kw):
            calls.append(_name)
            return _plain(*args, **kw)
        monkeypatch.setattr(ops, name, wrapped)
    if cuda:
        def adamw_stand_in(g, m, v, mw, p, hyper, **kw):
            assert hyper.shape == (4,) and hyper.dtype == torch.float32
            ops.adamw_plain(g, m, v, mw, hyper, **kw)
            p.copy_(mw)
        monkeypatch.setattr(ops, "_on_cuda", lambda t, what: True)
        monkeypatch.setattr(ops, "adamw_triton", adamw_stand_in)
        monkeypatch.setattr(ops, "grad_sumsq_triton", lambda gs: ops.grad_sumsq_plain(gs))
    ops.reset_launches()
    return ops, calls


@pytest.mark.parametrize("pdtype", [torch.float32, torch.bfloat16])
def test_cpu_update_takes_the_plain_path_without_launches(monkeypatch, pdtype):
    """CPU leaves run the plain versions, one update and one sum of squares
    a leaf, and count no launch."""
    ops, calls = _route_calls(monkeypatch, cuda=False)
    tp = _t(_tree(0), pdtype)
    st = optim.init(tp)
    for i in range(2):
        tp, st, _ = optim.update(_t(_tree(10 + i)), st, tp, optim.AdamWConfig())
    assert calls == (["grad_sumsq_plain"] + ["adamw_plain"] * 3) * 2
    assert ops.LAUNCHES["adamw"] == ops.LAUNCHES["grad_sumsq"] == 0


@pytest.mark.parametrize("clip", [0.05, 1e3], ids=["clip_active", "clip_inactive"])
def test_kernel_route_counts_a_launch_a_leaf_and_keeps_the_plain_bits(monkeypatch, clip):
    """Through the card's route (its launchers stood in for by the plain
    versions): one ``adamw`` and one ``grad_sumsq`` launch a leaf a step, a
    float32 (4,) ``hyper``, and the plain route's state bit for bit."""
    cfg = optim.AdamWConfig(lr=1e-2, grad_clip=clip)
    runs = []
    for cuda in (False, True):
        ops, _ = _route_calls(monkeypatch, cuda)
        tp = _t(_tree(0), torch.bfloat16)
        st = optim.init(tp)
        for i in range(3):
            tp, st, stats = optim.update(_t(_tree(10 + i), torch.bfloat16), st, tp, cfg,
                                         lr_scale=0.5 + 0.25 * i)
        runs.append((_flat(tp), _flat(st.master), _flat(st.m), _flat(st.v),
                     float(stats["grad_norm"]), dict(ops.LAUNCHES)))
        monkeypatch.undo()
    (*plain, plain_launches), (*card, card_launches) = runs
    assert plain_launches["adamw"] == plain_launches["grad_sumsq"] == 0
    assert card_launches["adamw"] == card_launches["grad_sumsq"] == 3 * 3
    for a, b in zip(plain[:4], card[:4]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert plain[4] == card[4]


def test_adamw_first_step_matches_closed_form():
    cfg = optim.AdamWConfig(lr=0.1, weight_decay=0.0, grad_clip=1e9)
    p = {"w": torch.ones(2)}
    newp, st2, _ = optim.update({"w": torch.tensor([0.5, -2.0])}, optim.init(p), p, cfg)
    np.testing.assert_allclose(newp["w"].numpy(), 1.0 - 0.1 * np.sign([0.5, -2.0]), rtol=1e-4)
    assert int(st2.step) == 1


def test_grad_clipping_and_global_norm():
    p = {"w": torch.zeros(3)}
    _, _, stats = optim.update({"w": torch.full((3,), 100.0)}, optim.init(p), p,
                               optim.AdamWConfig(lr=0.0, grad_clip=1.0))
    assert float(stats["grad_norm"]) == pytest.approx(np.sqrt(3) * 100, rel=1e-5)
    g = _tree(3)
    assert float(optim.global_norm(_t(g))) == pytest.approx(
        float(joptim.global_norm(_j(g))), rel=1e-6)


def test_weight_decay_pulls_to_zero():
    p = {"w": torch.full((2,), 2.0)}
    newp, *_ = optim.update({"w": torch.zeros(2)}, optim.init(p), p,
                            optim.AdamWConfig(lr=0.1, weight_decay=0.5, grad_clip=1e9))
    assert float(newp["w"][0]) < 2.0


@pytest.mark.parametrize("step", [0, 1, 7, 10, 55, 99, 100, 250])
def test_schedules_match_repro(step):
    for kw in ({}, {"warmup": 10, "total": 100}, {"warmup": 0, "total": 50, "min_ratio": 0.0}):
        assert float(optim.warmup_cosine(step, **kw)) == pytest.approx(
            float(joptim.warmup_cosine(step, **kw)), rel=1e-6, abs=1e-7)
    assert float(optim.constant(step)) == float(joptim.constant(step)) == 1.0


def test_quantize_matches_repro():
    g = np.random.default_rng(5).standard_normal((33, 17)).astype(np.float32)
    tq, ts = quantize(torch.from_numpy(g))
    from repro.optim.compression import quantize as jquantize
    jq, js = jquantize(jnp.asarray(g))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == pytest.approx(float(js), rel=1e-7)
    np.testing.assert_allclose(dequantize(tq, ts).numpy(), np.asarray(jq, np.float32) * float(js),
                               rtol=1e-6)


def test_compress_grads_error_feedback_matches_repro():
    """Five round trips with the residual carried: the decompressed grads and
    the residuals agree with repro's, and the byte ratio is int8's."""
    jef, tef = joptim.ef_init(_j(_tree(0))), optim.ef_init(_t(_tree(0)))
    for i in range(5):
        g = _tree(20 + i, scale=0.01)
        jg, jef, jratio = joptim.compress_grads(_j(g), jef)
        tg, tef, tratio = optim.compress_grads(_t(g), tef)
        _assert_tree_close(tg, jg, rtol=1e-6, atol=1e-9)
        _assert_tree_close(tef.residual, jef.residual, rtol=1e-5, atol=1e-9)
        assert tratio == pytest.approx(jratio) == pytest.approx(0.25)


def test_error_feedback_unbiased_over_time():
    g = {"w": torch.full((8,), 0.003)}
    ef = optim.ef_init(g)
    acc = torch.zeros(8)
    for _ in range(50):
        out, ef, _ = optim.compress_grads(g, ef)
        acc += out["w"]
    np.testing.assert_allclose((acc / 50).numpy(), 0.003, rtol=0.02)
