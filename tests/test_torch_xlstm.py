"""The port's xLSTM (family ``"ssm"``) against repro's on the smoke
xlstm-1.3b (2 blocks of 1 sLSTM and 1 mLSTM layer, d 128, 4 heads of 64,
chunk 32), from repro's own ``model.init(PRNGKey(0))`` weights carried
across with ``repro_torch.convert``: the param tree, the leaves kept
float32 under bf16, prefill logits and every cache tensor after a prompt
that pads its last chunk, decode logits, greedy tokens, decode against the
full forward; prompts of 1 and 2 tokens (shorter than the conv's W-1 = 3
rows), held to the port's own full forward, where repro's short conv tail
makes its decode raise; ``slstm_cell`` and ``mlstm_core`` across chunk
boundaries; the loss, every grad leaf, remat, the 5-step trajectory, the
train and serve drivers on the CPU. The model on the card:
tests/test_torch_cuda.py."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from tests.conftest import JAX_DRIFT_REASON, jax_api_drifted

pytestmark = pytest.mark.skipif(jax_api_drifted(), reason=JAX_DRIFT_REASON)

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro_torch.convert import from_numpy  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402
from tests import torch_train_parity as par  # noqa: E402

ARCH = "xlstm-1.3b"
CFG = get_smoke(ARCH)
B, S, N_DECODE, N_GREEDY = 2, 40, 4, 8      # S = 40 with chunk 32: a padded tail
REL_TOL = 1e-4                              # tests/test_models.py:100


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_build_model(CFG)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    # repro's prefill and decode step jitted once: eagerly its scans compile every call
    jmodel = jmodel._replace(prefill=jax.jit(jmodel.prefill, static_argnums=2),
                             decode_step=jax.jit(jmodel.decode_step))
    toks = np.random.default_rng(7).integers(0, CFG.vocab_size, (B, S + N_DECODE))
    return jmodel, jparams, build_model(CFG), from_numpy(par.np_tree(jparams)), \
        toks.astype(np.int32)


def test_port_keeps_repro_param_tree(pair):
    _, jparams, tmodel, tparams, _ = pair
    jflat = {"/".join(str(getattr(p, "key", p)) for p in path): leaf.shape
             for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert {k: tuple(v.shape) for k, v in par.flat(tparams).items()} == jflat
    assert jflat["mlstm/mlstm/wq/w"][:2] == (2, 1) and jflat["slstm/R"] == (2, 4, 4, 64, 64)
    own = tmodel.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in par.flat(own).items()} == jflat


def test_convert_keeps_w_gates_float32_under_bf16():
    """repro's smoke xLSTM in bf16 carried with dtype=bf16: both w_gates
    leaves float32, as repro keeps them, every other leaf bf16; the port's
    own init gives the same dtypes."""
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    jparams = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    got = {k: v.dtype for k, v in par.flat(from_numpy(par.np_tree(jparams),
                                                      dtype=torch.bfloat16)).items()}
    f32 = {k for k, d in got.items() if d == torch.float32}
    assert f32 == {"mlstm/mlstm/w_gates/w", "mlstm/mlstm/w_gates/b"}
    assert all(d == torch.bfloat16 for k, d in got.items() if k not in f32)
    want = {"/".join(str(getattr(p, "key", p)) for p in path): str(leaf.dtype)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert {k: str(d).removeprefix("torch.") for k, d in got.items()} == want
    own = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert {k: v.dtype for k, v in par.flat(own).items()} == got


def test_prefill_cache_and_decode_logits_match_repro(pair):
    jmodel, jparams, tmodel, tparams, toks = pair
    S_max = S + N_DECODE
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])}, S_max)
    tl, tcache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :S]).long()},
                                S_max)
    assert _rel(tl, jl) < REL_TOL
    assert sorted(tcache) == sorted(jcache)
    assert tcache["pos"].dtype == torch.int32 and tcache["pos"].dim() == 0
    assert int(tcache["pos"]) == int(jcache["pos"]) == S
    for key in ("s", "m"):
        for i, (got, want) in enumerate(zip(tcache[key], jcache[key], strict=True)):
            assert tuple(got.shape) == want.shape, (key, i)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4,
                                       err_msg=f"{key}[{i}]")
    for t in range(N_DECODE):
        tok = toks[:, S + t]
        jl, jcache = jmodel.decode_step(jparams, jcache, {"token": jnp.asarray(tok)})
        tl, tcache = tmodel.decode_step(tparams, tcache, {"token": torch.from_numpy(tok).long()})
        assert _rel(tl, jl) < REL_TOL
    assert int(tcache["pos"]) == S + N_DECODE


def test_greedy_tokens_match_repro(pair):
    jmodel, jparams, tmodel, tparams, toks = pair
    from repro_torch.launch.serve import generate
    prompts = toks[:, :S]
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompts)}, S + N_GREEDY)
    tok = jnp.argmax(jl, axis=-1)
    out = [tok]
    for _ in range(N_GREEDY - 1):
        jl, jcache = jmodel.decode_step(jparams, jcache, {"token": tok})
        tok = jnp.argmax(jl, axis=-1)
        out.append(tok)
    want = np.stack([np.asarray(t) for t in out], axis=1)
    got = generate(tmodel, tparams, torch.from_numpy(prompts).long(), N_GREEDY)["tokens"]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("prompt", [1, 2, S])
def test_decode_matches_full_forward(pair, prompt):
    """Decode after a prompt against the port's own full forward over prompt
    + 3 decoded tokens, within 2e-2 of max|logit| (tests/test_models.py:89).
    Prompts 1 and 2 are shorter than the conv's W-1 = 3 rows: the conv
    cache holds the zeros the causal conv pads with."""
    _, _, tmodel, tparams, toks = pair
    t = torch.from_numpy(toks[:, :prompt + 3]).long()
    _, cache = tmodel.prefill(tparams, {"tokens": t[:, :prompt]}, prompt + 3)
    for i in range(3):
        logits, cache = tmodel.decode_step(tparams, cache, {"token": t[:, prompt + i]})
    full, _ = tmodel.prefill(tparams, {"tokens": t}, prompt + 3)
    assert _rel(logits, full) < 2e-2


@pytest.mark.parametrize("prompt", [1, 2])
def test_repro_short_conv_tail_breaks_its_decode(pair, prompt):
    """The reference fault the port pads away: repro's prefill keeps
    ``x_in[:, -(W-1):]``, ``prompt`` rows after a shorter prompt, and its
    decode's conv window then has fewer rows than the conv's W taps: repro
    raises, where the port decodes as its full forward does (above)."""
    jmodel, jparams, _, _, toks = pair
    _, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :prompt])}, prompt + 3)
    assert jcache["m"][0].shape[3] == prompt                 # (nb, nm, B, rows, di)
    with pytest.raises((TypeError, ValueError)):
        jmodel.decode_step(jparams, jcache, {"token": jnp.asarray(toks[:, prompt])})


def test_mlstm_core_across_chunks_matches_repro():
    """Three chunks of 16 (the last padded), from the empty carry and from a
    given one: h and the carry against repro's ``mlstm_core``."""
    rng = np.random.default_rng(11)
    Bq, S_, H, dh, Q = 2, 40, 3, 8, 16
    q, k, v = (rng.standard_normal((Bq, S_, H, dh)).astype(np.float32) for _ in range(3))
    f_pre, i_pre = (rng.standard_normal((Bq, S_, H)).astype(np.float32) for _ in range(2))
    log_f = np.array(jax.nn.log_sigmoid(f_pre))
    carry = (rng.standard_normal((Bq, H, dh, dh)).astype(np.float32) * 0.1,
             rng.standard_normal((Bq, H, dh)).astype(np.float32) * 0.1,
             rng.standard_normal((Bq, H)).astype(np.float32))
    for c0 in (None, carry):
        jh, jc = jx.mlstm_core(*(jnp.asarray(a) for a in (q, k, v, log_f, i_pre)), Q,
                               None if c0 is None else tuple(jnp.asarray(a) for a in c0))
        th, tc = tx.mlstm_core(*(torch.from_numpy(a) for a in (q, k, v, log_f, i_pre)), Q,
                               None if c0 is None else tuple(torch.from_numpy(a) for a in c0))
        assert _rel(th, jh) < 1e-5
        for got, want in zip(tc, jc, strict=True):
            assert _rel(got, want) < 1e-5


def test_slstm_cell_across_steps_matches_repro(pair):
    """40 steps of the recurrence from the empty state on the smoke model's
    first sLSTM block's R: the state after every step against repro's."""
    _, jparams, _, tparams, _ = pair
    jp = jax.tree.map(lambda a: a[0], jparams["slstm"])
    Rw = tx.recurrent_weight(tparams["slstm"]["R"][0])
    xg = np.random.default_rng(12).standard_normal((B, S, 4, 4, 64)).astype(np.float32)
    g = tx.gate_inputs(torch.from_numpy(xg))
    js, ts = jx.empty_slstm_state(CFG, B), tx.empty_slstm_state(CFG, B)
    for t in range(S):
        js = jx.slstm_cell(jp, jnp.asarray(xg[:, t]), js)
        ts = tx.slstm_cell(Rw, g[t], ts)
        for got, want in zip(ts, js, strict=True):
            assert _rel(got, want) < 1e-5


def test_norm_inputs_are_contiguous(pair, monkeypatch):
    """The rmsnorm kernel takes contiguous rows only (the card raises on
    anything else, the CPU's plain version would not): every norm input of
    a prefill whose last chunk is padded, of a decode step and of a training
    forward and backward is contiguous."""
    from repro_torch.kernels import ops
    _, _, tmodel, tparams, toks = pair
    seen = []
    real = ops.rmsnorm

    def spy(x, scale, **kw):
        seen.append(x.is_contiguous())
        return real(x, scale, **kw)
    monkeypatch.setattr(ops, "rmsnorm", spy)
    t = torch.from_numpy(toks).long()
    _, cache = tmodel.prefill(tparams, {"tokens": t[:, :S]}, S + 1)
    tmodel.decode_step(tparams, cache, {"token": t[:, S]})
    batch = par.torch_batch(par.make_batch(CFG, B, S))
    par.port_grads(tmodel, tparams, batch, remat="full")
    assert len(seen) > 10 and all(seen)


# -- training -----------------------------------------------------------------
@pytest.fixture(scope="module")
def train_pair():
    """repro's loss jitted once: jax.grad through it eagerly compiles its
    scans at every call."""
    cfg, jmodel, jparams, tmodel, tparams = par.make_pair(CFG)
    jloss = jax.jit(jmodel.loss, static_argnames=("remat", "use_kernels"))
    return cfg, jmodel._replace(loss=jloss), jparams, tmodel, tparams


def test_loss_matches_repro(train_pair):
    par.check_loss(train_pair, par.make_batch(CFG, B, 48), use_kernels=False)


def test_grads_match_jax_grad(train_pair):
    par.check_grads(train_pair, par.make_batch(CFG, B, 48))


def test_remat_full_gives_the_same_grads(train_pair):
    par.check_remat(train_pair, par.make_batch(CFG, B, 48))


def test_five_step_trajectory_matches_repro():
    par.check_trajectory(CFG, par.make_batch(CFG, B, 48, seed=21))


def test_train_driver_on_cpu():
    par.check_train_driver(ARCH)


def test_serve_end_to_end_on_cpu():
    from repro_torch.configs import get_smoke as port_smoke
    from repro_torch.launch import serve as serve_mod
    cfg = port_smoke(ARCH)
    res = serve_mod.serve(cfg, requests=2, prompt_len=S, gen=4, seed=0, device="cpu",
                          log=lambda s: None)
    assert res["generated"] == (2, 4)
    assert int(res["tokens"].min()) >= 0 and int(res["tokens"].max()) < cfg.padded_vocab
    assert res["stage_bytes"] == res["published_bytes"]
