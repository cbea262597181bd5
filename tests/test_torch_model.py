"""The port's dense LM against repro's on the smoke qwen3-14b (qk-norm, GQA),
from repro's own ``model.init(PRNGKey(0))`` weights carried across with
``repro_torch.convert``: prefill logits, logits after decode steps and greedy
tokens, with repro's ``use_kernels`` on (Pallas interpret mode) and off."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from tests.conftest import JAX_DRIFT_REASON, jax_api_drifted

pytestmark = pytest.mark.skipif(jax_api_drifted(), reason=JAX_DRIFT_REASON)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.attention import sdpa as jax_sdpa  # noqa: E402
from repro_torch.convert import from_numpy  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.attention import sdpa  # noqa: E402

B, S, N_DECODE, N_GREEDY = 2, 32, 4, 16
REL_TOL = 1e-4          # kernel path vs reference path (tests/test_models.py:100)


def _to_port(params, dtype):
    """repro params -> the port's, widening bf16 (ml_dtypes) through float32."""
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), params)
    return from_numpy(tree, device="cpu", dtype=dtype)


@pytest.fixture(scope="module")
def pair():
    cfg = get_smoke("qwen3-14b")
    jmodel = jax_build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(cfg)
    tparams = _to_port(jparams, torch.float32)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S + N_DECODE))
    return cfg, jmodel, jparams, tmodel, tparams, toks.astype(np.int32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def test_port_keeps_repro_param_tree(pair):
    cfg, _, jparams, _, tparams, _ = pair
    jflat = {"/".join(str(getattr(p, "key", p)) for p in path): leaf.shape
             for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]}

    def flat(t, pre=""):
        if isinstance(t, dict):
            out = {}
            for k, v in t.items():
                out.update(flat(v, f"{pre}{k}/"))
            return out
        return {pre.rstrip("/"): tuple(t.shape)}

    assert flat(tparams) == jflat
    assert jflat["layers/attn/wq/w"] == (cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.hd)
    # the port's own init builds the same tree
    own = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert flat(own) == jflat


@pytest.mark.parametrize("use_kernels", [False, True])
def test_prefill_and_decode_logits_match_repro(pair, use_kernels):
    _, jmodel, jparams, tmodel, tparams, toks = pair
    S_max = S + N_DECODE
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])}, S_max,
                                use_kernels=use_kernels)
    tl, tcache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :S]).long()},
                                S_max)
    assert _rel(tl, jl) < REL_TOL
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), atol=1e-5)
    assert int(tcache["pos"]) == int(jcache["pos"]) == S
    for t in range(N_DECODE):
        tok = toks[:, S + t]
        jl, jcache = jmodel.decode_step(jparams, jcache, {"token": jnp.asarray(tok)},
                                        use_kernels=use_kernels)
        tl, tcache = tmodel.decode_step(tparams, tcache, {"token": torch.from_numpy(tok).long()})
    assert _rel(tl, jl) < REL_TOL
    assert int(tcache["pos"]) == S + N_DECODE


@pytest.mark.parametrize("use_kernels", [False, True])
def test_greedy_tokens_match_repro(pair, use_kernels):
    _, jmodel, jparams, tmodel, tparams, toks = pair
    from repro_torch.launch.serve import generate
    prompts = toks[:, :S]
    S_max = S + N_GREEDY
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompts)}, S_max,
                                use_kernels=use_kernels)
    tok = jnp.argmax(jl, axis=-1)
    out = [tok]
    for _ in range(N_GREEDY - 1):
        jl, jcache = jmodel.decode_step(jparams, jcache, {"token": tok},
                                        use_kernels=use_kernels)
        tok = jnp.argmax(jl, axis=-1)
        out.append(tok)
    want = np.stack([np.asarray(t) for t in out], axis=1)
    got = generate(tmodel, tparams, torch.from_numpy(prompts).long(), N_GREEDY)["tokens"]
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_matches_full_forward(pair):
    """The port's own check, as tests/test_models.py:73-89 does for repro."""
    _, _, _, tmodel, tparams, toks = pair
    t = torch.from_numpy(toks).long()
    S_max = S + N_DECODE
    _, cache = tmodel.prefill(tparams, {"tokens": t[:, :S]}, S_max)
    for i in range(N_DECODE):
        logits, cache = tmodel.decode_step(tparams, cache, {"token": t[:, S + i]})
    full, _ = tmodel.prefill(tparams, {"tokens": t}, S_max)
    assert _rel(logits, full) < 2e-2


def test_bf16_prefill_close_to_repro():
    """The working dtype of the published config: bf16 weights and
    activations, held at the bf16 kernel tolerance relative to max|logit|."""
    cfg = dataclasses.replace(get_smoke("qwen3-14b"), dtype="bfloat16")
    jmodel = jax_build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jl, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, S)
    tl, _ = build_model(cfg).prefill(_to_port(jparams, torch.bfloat16),
                                     {"tokens": torch.from_numpy(toks).long()}, S)
    assert tl.dtype == torch.bfloat16
    assert _rel(tl.float(), jnp.asarray(jl, jnp.float32)) < 5e-2


@pytest.mark.parametrize("window", [None, 8])
def test_sdpa_matches_repro_masks(window):
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 1, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 24, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 24, 2, 32)).astype(np.float32)
    want = jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                    window=window, q_offset=13, kv_len=14)
    got = sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True,
               window=window, q_offset=torch.tensor(13), kv_len=torch.tensor(14))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_build_model_refuses_unported_families():
    from repro_torch.configs import get_smoke as port_smoke
    for arch in ("qwen3-moe-30b-a3b", "gemma3-12b", "zamba2-7b", "whisper-tiny"):
        with pytest.raises(NotImplementedError):
            build_model(port_smoke(arch))
