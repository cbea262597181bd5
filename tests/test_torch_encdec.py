"""The port's Whisper encoder-decoder (family ``"audio"``, precomputed frame
embeddings as the stub of its audio frontend) against repro's on the smoke
whisper-tiny (2 encoder and 2 decoder layers, d 128, 64 frames), from
repro's own ``model.init(PRNGKey(0))`` weights carried across with
``repro_torch.convert`` and seeded frames made with numpy: the param tree,
``encode``, the cross-attention (S queries against T encoder keys),
prefill logits and every cache tensor, decode logits, greedy tokens, decode
against the full forward; the loss, every grad leaf, remat and the 5-step
trajectory; the train driver, ``launch.profile --train`` and the serve
driver feeding every batch zero frames, as repro's drivers do, and the loss
on the train driver's batch against repro's. The model on the card:
tests/test_torch_cuda.py."""

import pytest

torch = pytest.importorskip("torch")

import argparse  # noqa: E402

import numpy as np

from tests.conftest import JAX_DRIFT_REASON, jax_api_drifted

pytestmark = pytest.mark.skipif(jax_api_drifted(), reason=JAX_DRIFT_REASON)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import encdec as jenc  # noqa: E402
from repro.models.attention import attention as jax_attention  # noqa: E402
from repro_torch.convert import from_numpy  # noqa: E402
from repro_torch.launch import profile as profile_mod  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import encdec as tenc  # noqa: E402
from repro_torch.models.layers import dtype_of  # noqa: E402
from tests import torch_train_parity as par  # noqa: E402

ARCH = "whisper-tiny"
CFG = get_smoke(ARCH)
T_ENC = CFG.encoder_seq
B, S, N_DECODE, N_GREEDY = 2, 24, 4, 8
REL_TOL = 1e-4                              # tests/test_models.py:100


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def _frames(seed=7, n=B):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((n, T_ENC, CFG.d_model))).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_build_model(CFG)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    # repro's prefill and decode step jitted once: eagerly their scans
    # compile every call
    jmodel = jmodel._replace(prefill=jax.jit(jmodel.prefill, static_argnums=2),
                             decode_step=jax.jit(jmodel.decode_step))
    toks = np.random.default_rng(5).integers(0, CFG.vocab_size, (B, S + N_GREEDY))
    return jmodel, jparams, build_model(CFG), from_numpy(par.np_tree(jparams)), \
        toks.astype(np.int32), _frames()


def _batches(toks, frames, n):
    return ({"tokens": jnp.asarray(toks[:, :n]), "frames": jnp.asarray(frames)},
            {"tokens": torch.from_numpy(toks[:, :n]).long(),
             "frames": torch.from_numpy(frames)})


def test_port_keeps_repro_param_tree(pair):
    _, jparams, tmodel, tparams, _, _ = pair
    jflat = {"/".join(str(getattr(p, "key", p)) for p in path): leaf.shape
             for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert {k: tuple(v.shape) for k, v in par.flat(tparams).items()} == jflat
    assert jflat["dec_layers/cross_attn/wk/w"][0] == CFG.n_layers
    assert jflat["enc_layers/attn/wq/w"][0] == CFG.encoder_layers
    own = tmodel.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in par.flat(own).items()} == jflat


def test_encode_matches_repro(pair):
    _, jparams, _, tparams, _, frames = pair
    want = jenc.encode(jparams, CFG, jnp.asarray(frames))
    got = tenc.encode(tparams, CFG, torch.from_numpy(frames))
    assert got.shape == (B, T_ENC, CFG.d_model)
    assert _rel(got, want) < REL_TOL


@pytest.mark.parametrize("n_q", [1, 24])
def test_cross_attention_matches_repro(pair, n_q):
    """One decoder layer's cross-attention: q from x, k/v given (T = 64 keys,
    n_q queries), no rope, non-causal; at one query row under no_grad the
    decode path, else the flash path."""
    _, jparams, _, tparams, _, _ = pair
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, n_q, CFG.d_model)).astype(np.float32)
    kv = [rng.standard_normal((B, T_ENC, CFG.n_kv_heads, CFG.hd)).astype(np.float32)
          for _ in range(2)]
    jp = jax.tree.map(lambda a: a[0], jparams["dec_layers"]["cross_attn"])
    want, _ = jax_attention(jp, jnp.asarray(x), CFG, positions=jnp.arange(n_q), theta=0.0,
                            kv_override=tuple(jnp.asarray(a) for a in kv))
    tp = {k: {kk: vv[0] for kk, vv in v.items()}
          for k, v in tparams["dec_layers"]["cross_attn"].items()}
    with torch.no_grad():
        got, none = tattn.attention(tp, torch.from_numpy(x), CFG,
                                    positions=torch.arange(n_q), theta=0.0,
                                    kv_override=tuple(torch.from_numpy(a) for a in kv))
    assert none is None and _rel(got, want) < REL_TOL


def test_prefill_cache_and_decode_logits_match_repro(pair):
    jmodel, jparams, tmodel, tparams, toks, frames = pair
    S_max = S + N_DECODE
    jb, tb = _batches(toks, frames, S)
    jl, jcache = jmodel.prefill(jparams, jb, S_max)
    tl, tcache = tmodel.prefill(tparams, tb, S_max)
    assert _rel(tl, jl) < REL_TOL
    assert sorted(tcache) == sorted(jcache)
    assert tcache["pos"].dtype == torch.int32 and tcache["pos"].dim() == 0
    assert int(tcache["pos"]) == int(jcache["pos"]) == S
    for key in ("k", "v", "ck", "cv"):
        assert tuple(tcache[key].shape) == jcache[key].shape, key
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]),
                                   atol=2e-4, rtol=2e-4, err_msg=key)
    for t in range(N_DECODE):
        tok = toks[:, S + t]
        jl, jcache = jmodel.decode_step(jparams, jcache, {"token": jnp.asarray(tok)})
        tl, tcache = tmodel.decode_step(tparams, tcache, {"token": torch.from_numpy(tok).long()})
        assert _rel(tl, jl) < REL_TOL
    assert int(tcache["pos"]) == S + N_DECODE


def test_greedy_tokens_match_repro(pair):
    jmodel, jparams, tmodel, tparams, toks, frames = pair
    jb, _ = _batches(toks, frames, S)
    jl, jcache = jmodel.prefill(jparams, jb, S + N_GREEDY)
    tok = jnp.argmax(jl, axis=-1)
    out = [tok]
    for _ in range(N_GREEDY - 1):
        jl, jcache = jmodel.decode_step(jparams, jcache, {"token": tok})
        tok = jnp.argmax(jl, axis=-1)
        out.append(tok)
    want = np.stack([np.asarray(t) for t in out], axis=1)
    got = serve_mod.generate(tmodel, tparams, torch.from_numpy(toks[:, :S]).long(), N_GREEDY,
                             frames=torch.from_numpy(frames))["tokens"]
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_matches_full_forward(pair):
    _, _, tmodel, tparams, toks, frames = pair
    _, tb = _batches(toks, frames, S)
    S_max = S + N_DECODE
    t = torch.from_numpy(toks[:, :S_max]).long()
    _, cache = tmodel.prefill(tparams, tb, S_max)
    for i in range(N_DECODE):
        logits, cache = tmodel.decode_step(tparams, cache, {"token": t[:, S + i]})
    full, _ = tmodel.prefill(tparams, dict(tb, tokens=t), S_max)
    assert _rel(logits, full) < 2e-2


def test_norm_inputs_are_contiguous(pair, monkeypatch):
    """The rmsnorm kernel takes contiguous rows only: every norm input of a
    prefill, a decode step and a training forward and backward is."""
    from repro_torch.kernels import ops
    _, _, tmodel, tparams, toks, frames = pair
    seen = []
    real = ops.rmsnorm

    def spy(x, scale, **kw):
        seen.append(x.is_contiguous())
        return real(x, scale, **kw)
    monkeypatch.setattr(ops, "rmsnorm", spy)
    _, tb = _batches(toks, frames, S)
    _, cache = tmodel.prefill(tparams, tb, S + 1)
    tmodel.decode_step(tparams, cache, {"token": torch.from_numpy(toks[:, S]).long()})
    par.port_grads(tmodel, tparams, par.torch_batch(_train_batch()), remat="full")
    assert len(seen) > 10 and all(seen)


# -- training -----------------------------------------------------------------
def _train_batch(seed=3):
    batch = par.make_batch(CFG, B, S, seed=seed)
    batch["frames"] = _frames(seed)
    return batch


@pytest.fixture(scope="module")
def train_pair():
    """repro's loss jitted once: jax.grad through it eagerly compiles its
    scans at every call."""
    cfg, jmodel, jparams, tmodel, tparams = par.make_pair(CFG)
    jloss = jax.jit(jmodel.loss, static_argnames=("remat", "use_kernels"))
    return cfg, jmodel._replace(loss=jloss), jparams, tmodel, tparams


def test_loss_matches_repro(train_pair):
    par.check_loss(train_pair, _train_batch(), use_kernels=False)


def test_grads_match_jax_grad(train_pair):
    par.check_grads(train_pair, _train_batch())


def test_remat_full_gives_the_same_grads(train_pair):
    par.check_remat(train_pair, _train_batch())


def test_five_step_trajectory_matches_repro():
    par.check_trajectory(CFG, _train_batch(seed=21))


def test_train_driver_on_cpu():
    par.check_train_driver(ARCH)


# -- the drivers feed frames -------------------------------------------------------
def _zero_frames_ok(batch, cfg) -> None:
    fr = batch["frames"]
    assert tuple(fr.shape) == (batch["tokens"].shape[0], cfg.encoder_seq, cfg.d_model)
    assert fr.dtype == dtype_of(cfg) and not bool(fr.any())


def _step_spy(real, seen):
    def make(model, rt):
        step = real(model, rt)

        def run(state, batch):
            seen.append(batch)
            return step(state, batch)
        return run
    return make


def test_train_driver_feeds_zero_frames(monkeypatch):
    """``launch.train.train`` on the smoke whisper (1 step, B 2): the step
    batch and every batch the loss sees (the held-out eval before and after,
    and the step's own) carry zero frames (B, encoder_seq, d), as
    ``src/repro/launch/train.py``'s ``to_jax`` feeds them."""
    from repro_torch.configs import get_smoke as port_smoke
    cfg = port_smoke(ARCH)
    steps, losses = [], []
    real_build = train_mod.build_model

    def build(c):
        model = real_build(c)

        def loss(params, batch, **kw):
            losses.append(batch)
            return model.loss(params, batch, **kw)
        return model._replace(loss=loss)
    monkeypatch.setattr(train_mod, "make_train_step", _step_spy(train_mod.make_train_step, steps))
    monkeypatch.setattr(train_mod, "build_model", build)
    res = train_mod.train(cfg, steps=1, batch=2, seq=16, device="cpu", log=lambda s: None)
    assert len(steps) == 1 and len(losses) >= 3 and np.isfinite(res["losses"]).all()
    for b in steps + losses:
        _zero_frames_ok(b, cfg)


def test_profile_train_batches_carry_zero_frames(monkeypatch):
    """``launch.profile --train --arch whisper-tiny`` builds its batches
    through the same ``to_device`` (run here on the smoke config, the
    profiler window replaced by one call)."""
    import repro_torch.runtime as runtime
    from repro_torch.configs import get_smoke as port_smoke
    steps = []
    monkeypatch.setattr(runtime, "make_train_step", _step_spy(runtime.make_train_step, steps))
    monkeypatch.setattr(profile_mod, "get_config", port_smoke)
    monkeypatch.setattr(profile_mod, "profile_window", lambda fn, dev, top: fn() or {})
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "cpu")
    args = argparse.Namespace(arch=ARCH, layers=1, batch=2, seq=16, seed=0, top=4)
    profile_mod.profile_train(args, torch.device("cpu"))
    assert len(steps) == 2
    for b in steps:
        _zero_frames_ok(b, port_smoke(ARCH))


def test_serve_driver_feeds_zero_frames(monkeypatch):
    """``launch.serve.serve`` on the smoke whisper: the prefill's batch
    carries zero frames, and S_max is the prompt and the generated tokens."""
    from repro_torch.configs import get_smoke as port_smoke
    cfg = port_smoke(ARCH)
    seen = []
    real_build = serve_mod.build_model

    def build(c):
        model = real_build(c)

        def prefill(params, batch, S_max):
            seen.append((batch, S_max))
            return model.prefill(params, batch, S_max)
        return model._replace(prefill=prefill)
    monkeypatch.setattr(serve_mod, "build_model", build)
    res = serve_mod.serve(cfg, requests=2, prompt_len=12, gen=3, seed=0, device="cpu",
                          log=lambda s: None)
    assert res["generated"] == (2, 3) and res["stage_bytes"] == res["published_bytes"]
    (batch, S_max), = seen
    _zero_frames_ok(batch, cfg)
    assert S_max == 12 + 3


@pytest.mark.parametrize("use_kernels", [False, True])
def test_loss_on_the_train_drivers_batch_matches_repro(train_pair, use_kernels):
    """The batch ``launch.train.to_device`` makes from a loader batch (tokens,
    labels and zero frames) against repro's driver's batch of the same
    tokens with its float32 zero frames: the losses within 1e-4
    (``use_kernels`` is taken and not read by repro's encoder-decoder)."""
    from repro_torch.configs import get_smoke as port_smoke
    _, jmodel, jparams, tmodel, tparams = train_pair
    loader_batch = par.make_batch(CFG, B, S, seed=4)
    tb = train_mod.to_device(loader_batch, port_smoke(ARCH), torch.device("cpu"))
    jb = par.jax_batch(loader_batch)
    jb["frames"] = jnp.zeros((B, T_ENC, CFG.d_model), jnp.float32)
    jloss, _ = jmodel.loss(jparams, jb, use_kernels=use_kernels)
    with torch.no_grad():
        tloss, _ = tmodel.loss(tparams, tb)
    assert abs(float(tloss) - float(jloss)) < REL_TOL
