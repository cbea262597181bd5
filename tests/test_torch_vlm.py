"""The port's VLM (internvl2 with precomputed patch embeddings, the stub of
its vision frontend) against repro's on the smoke internvl2-2b, from repro's
own ``model.init(PRNGKey(0))`` weights carried across with
``repro_torch.convert`` and patch embeddings made with numpy: the param tree,
prefill and decode logits, the cache (the prefix counted in it), greedy
tokens and the loss (the prefix rows dropped before the unembed) with
repro's ``use_kernels`` on (Pallas interpret mode) and off; decode against
the port's own full forward; the serve driver on the CPU for both new
families; the train driver and ``launch.profile --train`` feeding every
batch a prefix of zero patch embeddings, as repro's train driver does, and
the loss on such a batch against repro's; the audio and ssm families,
which ``build_model`` once refused, built."""

import pytest

torch = pytest.importorskip("torch")

import argparse

import numpy as np

from tests.conftest import JAX_DRIFT_REASON, jax_api_drifted

pytestmark = pytest.mark.skipif(jax_api_drifted(), reason=JAX_DRIFT_REASON)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.convert import from_numpy  # noqa: E402
from repro_torch.launch import profile as profile_mod  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import dtype_of  # noqa: E402

B, S, N_DECODE, N_GREEDY = 2, 32, 4, 16
REL_TOL = 1e-4                              # tests/test_models.py:100
CFG = get_smoke("internvl2-2b")
NP = CFG.n_patches


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_build_model(CFG)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jmodel = jmodel._replace(decode_step=jax.jit(jmodel.decode_step,
                                                 static_argnames="use_kernels"))
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jparams)
    tparams = from_numpy(tree, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, CFG.vocab_size, (B, S + N_GREEDY)).astype(np.int32)
    pe = (0.1 * rng.standard_normal((B, NP, CFG.d_model))).astype(np.float32)
    return jmodel, jparams, build_model(CFG), tparams, toks, pe


def _batches(toks, pe, n):
    return ({"tokens": jnp.asarray(toks[:, :n]), "patch_embeds": jnp.asarray(pe)},
            {"tokens": torch.from_numpy(toks[:, :n]).long(),
             "patch_embeds": torch.from_numpy(pe)})


def test_port_keeps_repro_param_tree(pair):
    _, jparams, tmodel, tparams, _, _ = pair

    def flat(t, pre=""):
        if isinstance(t, dict):
            out = {}
            for k, v in t.items():
                out.update(flat(v, f"{pre}{k}/"))
            return out
        return {pre.rstrip("/"): tuple(t.shape)}

    jflat = {"/".join(str(getattr(p, "key", p)) for p in path): leaf.shape
             for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert flat(tparams) == jflat
    assert flat(tmodel.init(torch.Generator().manual_seed(0))) == jflat


@pytest.mark.parametrize("use_kernels", [False, True])
def test_prefill_and_decode_logits_match_repro(pair, use_kernels):
    jmodel, jparams, tmodel, tparams, toks, pe = pair
    S_max = NP + S + N_DECODE
    jb, tb = _batches(toks, pe, S)
    jl, jc = jmodel.prefill(jparams, jb, S_max, use_kernels=use_kernels)
    tl, tc = tmodel.prefill(tparams, tb, S_max)
    assert _rel(tl, jl) < REL_TOL
    # the prefix is in the cache: NP + S positions, then the zero tail
    assert int(tc["pos"]) == int(jc["pos"]) == NP + S
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), atol=1e-5)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]), atol=1e-5)
    assert not tc["k"][:, :, NP + S:].any()
    for t in range(N_DECODE):
        tok = toks[:, S + t]
        jl, jc = jmodel.decode_step(jparams, jc, {"token": jnp.asarray(tok)},
                                    use_kernels=use_kernels)
        tl, tc = tmodel.decode_step(tparams, tc, {"token": torch.from_numpy(tok).long()})
        assert _rel(tl, jl) < REL_TOL
    assert int(tc["pos"]) == NP + S + N_DECODE


@pytest.mark.parametrize("use_kernels", [False, True])
def test_greedy_tokens_match_repro(pair, use_kernels):
    jmodel, jparams, tmodel, tparams, toks, pe = pair
    jb, _ = _batches(toks, pe, S)
    jl, jc = jmodel.prefill(jparams, jb, NP + S + N_GREEDY, use_kernels=use_kernels)
    tok = jnp.argmax(jl, axis=-1)
    out = [tok]
    for _ in range(N_GREEDY - 1):
        jl, jc = jmodel.decode_step(jparams, jc, {"token": tok}, use_kernels=use_kernels)
        tok = jnp.argmax(jl, axis=-1)
        out.append(tok)
    want = np.stack([np.asarray(t) for t in out], axis=1)
    got = serve_mod.generate(tmodel, tparams, torch.from_numpy(toks[:, :S]).long(), N_GREEDY,
                             torch.from_numpy(pe))["tokens"]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_loss_matches_repro(pair, use_kernels):
    """Labels cover the tokens only: the prefix rows are dropped before the
    unembed on both sides."""
    jmodel, jparams, tmodel, tparams, toks, pe = pair
    labels = np.roll(toks[:, :S], -1, axis=1)
    labels[:, -1] = -100
    jb, tb = _batches(toks, pe, S)
    jloss, _ = jmodel.loss(jparams, dict(jb, labels=jnp.asarray(labels)),
                           use_kernels=use_kernels)
    tloss, _ = tmodel.loss(tparams, dict(tb, labels=torch.from_numpy(labels).long()))
    assert abs(float(tloss) - float(jloss)) < REL_TOL


def test_prefix_changes_the_logits(pair):
    """The patch embeddings reach the tokens' logits (a prefix of zeros and
    the seeded one give different logits), and without them the VLM is the
    plain LM over its tokens."""
    _, _, tmodel, tparams, toks, pe = pair
    _, tb = _batches(toks, pe, S)
    with_pe, _ = tmodel.prefill(tparams, tb, NP + S)
    zeros = torch.zeros_like(tb["patch_embeds"])
    zero_pe, _ = tmodel.prefill(tparams, dict(tb, patch_embeds=zeros), NP + S)
    tokens_only, cache = tmodel.prefill(tparams, {"tokens": tb["tokens"]}, S)
    assert _rel(with_pe, zero_pe) > 1e-3
    assert int(cache["pos"]) == S and tokens_only.shape == with_pe.shape


def test_decode_matches_full_forward(pair):
    """As tests/test_models.py:73-89, on the port alone."""
    _, _, tmodel, tparams, toks, pe = pair
    _, tb = _batches(toks, pe, S)
    t = torch.from_numpy(toks[:, :S + N_DECODE]).long()
    S_max = NP + S + N_DECODE
    _, cache = tmodel.prefill(tparams, tb, S_max)
    for i in range(N_DECODE):
        logits, cache = tmodel.decode_step(tparams, cache, {"token": t[:, S + i]})
    full, _ = tmodel.prefill(tparams, dict(tb, tokens=t), S_max)
    assert _rel(logits, full) < 2e-2


@pytest.mark.parametrize("arch", ["gemma3-12b", "internvl2-2b"])
def test_serve_end_to_end_on_cpu(arch):
    """The serve driver on the smoke config: published, staged, restored,
    served; gemma3's 40-token prompt wraps its 32-slot ring, internvl2's
    requests carry seeded patch embeddings."""
    from repro_torch.configs import get_smoke as port_smoke
    cfg = port_smoke(arch)
    res = serve_mod.serve(cfg, requests=3, prompt_len=40, gen=5, seed=0, device="cpu",
                          log=lambda s: None)
    assert res["generated"] == (3, 5)
    assert int(res["tokens"].min()) >= 0 and int(res["tokens"].max()) < cfg.padded_vocab
    assert res["stage_bytes"] == res["published_bytes"]
    again = serve_mod.main(["--arch", arch, "--requests", "3", "--prompt-len", "40",
                            "--gen", "5", "--device", "cpu"])
    assert torch.equal(again["tokens"], res["tokens"])


def test_make_patch_embeds_is_seeded():
    a = serve_mod.make_patch_embeds(CFG, 2, "cpu", 5)
    assert a.shape == (2, NP, CFG.d_model) and a.dtype == torch.float32
    assert torch.equal(a, serve_mod.make_patch_embeds(CFG, 2, "cpu", 5))
    assert 0.05 < float(a.std()) < 0.15


def _zero_prefix_ok(batch, cfg) -> None:
    pe = batch["patch_embeds"]
    assert tuple(pe.shape) == (batch["tokens"].shape[0], cfg.n_patches, cfg.d_model)
    assert pe.dtype == dtype_of(cfg) and not bool(pe.any())


def _step_spy(real, seen):
    def make(model, rt):
        step = real(model, rt)

        def run(state, batch):
            seen.append(batch)
            return step(state, batch)
        return run
    return make


def test_train_driver_feeds_the_zero_prefix(monkeypatch):
    """``launch.train.train`` on the smoke internvl2 (1 step, B 2): the step
    batch and every batch the model's loss sees (the held-out eval before and
    after, and the step's own) carry zero patch embeddings (B, n_patches,
    d), as ``src/repro/launch/train.py``'s ``to_jax`` feeds them."""
    from repro_torch.configs import get_smoke as port_smoke
    cfg = port_smoke("internvl2-2b")
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
        _zero_prefix_ok(b, cfg)


def test_profile_train_batches_carry_the_zero_prefix(monkeypatch):
    """``launch.profile --train --arch internvl2-2b`` builds its batches
    through the same ``to_device``: the warm-up and the profiled step get
    the zero prefix (run here on the smoke config, the profiler window
    replaced by one call)."""
    import repro_torch.runtime as runtime
    from repro_torch.configs import get_smoke as port_smoke
    steps = []
    monkeypatch.setattr(runtime, "make_train_step", _step_spy(runtime.make_train_step, steps))
    monkeypatch.setattr(profile_mod, "get_config", port_smoke)
    monkeypatch.setattr(profile_mod, "profile_window", lambda fn, dev, top: fn() or {})
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "cpu")
    args = argparse.Namespace(arch="internvl2-2b", layers=1, batch=2, seq=16, seed=0, top=4)
    profile_mod.profile_train(args, torch.device("cpu"))
    assert len(steps) == 2
    for b in steps:
        _zero_prefix_ok(b, port_smoke("internvl2-2b"))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_loss_on_the_train_drivers_batch_matches_repro(pair, use_kernels):
    """The batch ``launch.train.to_device`` makes from a loader batch
    (tokens, labels and the zero prefix) against repro's driver's batch of
    the same tokens with its float32 zero prefix, from repro's init
    weights: the losses within 1e-4."""
    from repro_torch.configs import get_smoke as port_smoke
    jmodel, jparams, tmodel, tparams, toks, _ = pair
    labels = np.roll(toks[:, :S], -1, axis=1)
    labels[:, -1] = -100
    loader_batch = {"tokens": toks[:, :S], "labels": labels.astype(np.int32)}
    tb = train_mod.to_device(loader_batch, port_smoke("internvl2-2b"), torch.device("cpu"))
    jb = {k: jnp.asarray(v) for k, v in loader_batch.items()}
    jb["patch_embeds"] = jnp.zeros((B, NP, CFG.d_model), jnp.float32)
    jloss, _ = jmodel.loss(jparams, jb, use_kernels=use_kernels)
    tloss, _ = tmodel.loss(tparams, tb)
    assert abs(float(tloss) - float(jloss)) < REL_TOL


@pytest.mark.parametrize("arch", ["whisper-tiny", "xlstm-1.3b"])
def test_build_model_still_refuses_audio_and_ssm(arch):
    """The two families this test once found refused are ported now:
    ``build_model`` builds each through its own module, and its init gives
    repro's param tree (the full checks: tests/test_torch_encdec.py and
    tests/test_torch_xlstm.py)."""
    from repro_torch.configs import get_smoke as port_smoke
    cfg = port_smoke(arch)
    model = build_model(cfg)
    assert model.prefill.func.__module__.rsplit(".", 1)[-1] == \
        {"audio": "encdec", "ssm": "xlstm_model"}[cfg.family]
    jparams = jax.eval_shape(jax_build_model(get_smoke(arch)).init, jax.random.PRNGKey(0))
    want = {"/".join(str(getattr(p, "key", p)) for p in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    got = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else k)
        else:
            got[path] = tuple(node.shape)
    walk(model.init(torch.Generator().manual_seed(0)), "")
    assert got == want
