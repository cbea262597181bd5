"""The port's gemma3 local/global pattern against repro's on the smoke
gemma3-12b (6 layers: 2 blocks of 2 local layers and 1 global, window 32),
from repro's own ``model.init(PRNGKey(0))`` weights carried across with
``repro_torch.convert``: the param tree, prefill and decode logits, greedy
tokens and the loss with repro's ``use_kernels`` on (Pallas interpret mode)
and off; every cache tensor after prompts shorter than, equal to, a multiple
of and out of step with the window; decode after a wrapping prompt held to
the port's own full forward (where repro's ring is misaligned: ROADMAP
Queue 3); ``blockwise_sdpa`` and the ring decode against repro's
attention."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from tests.conftest import JAX_DRIFT_REASON, jax_api_drifted

pytestmark = pytest.mark.skipif(jax_api_drifted(), reason=JAX_DRIFT_REASON)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.attention import blockwise_sdpa as jax_blockwise_sdpa  # noqa: E402
from repro.models.attention import sdpa as jax_sdpa  # noqa: E402
from repro_torch.convert import from_numpy, keeps_float32  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

B, S, N_DECODE, N_GREEDY = 2, 32, 4, 16     # S = W: repro's ring is aligned
REL_TOL = 1e-4                              # tests/test_models.py:100
CFG = get_smoke("gemma3-12b")
W = CFG.sliding_window


def _to_port(params):
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), params)
    return from_numpy(tree, device="cpu", dtype=torch.float32)


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}{k}/"))
        return out
    return {pre.rstrip("/"): tree}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_build_model(CFG)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    # repro's decode step jitted once: run eagerly, its scans compile every step
    jmodel = jmodel._replace(decode_step=jax.jit(jmodel.decode_step,
                                                 static_argnames="use_kernels"))
    toks = np.random.default_rng(7).integers(0, CFG.vocab_size, (B, 70 + N_DECODE))
    return jmodel, jparams, build_model(CFG), _to_port(jparams), toks.astype(np.int32)


def test_port_keeps_repro_param_tree(pair):
    _, jparams, tmodel, tparams, _ = pair
    jflat = {"/".join(str(getattr(p, "key", p)) for p in path): leaf.shape
             for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    got = {k: tuple(v.shape) for k, v in _flat(tparams).items()}
    assert got == jflat
    R, G = CFG.local_global_ratio, CFG.n_layers // (CFG.local_global_ratio + 1)
    assert jflat["local_layers/attn/wq/w"][:2] == (G, R)
    assert jflat["global_layers/attn/q_norm"] == (G, CFG.hd)
    own = tmodel.init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in _flat(own).items()} == jflat
    # convert's float32 rules match no leaf of the family
    assert not any(keeps_float32(k) for k in jflat)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_prefill_and_decode_logits_match_repro(pair, use_kernels):
    jmodel, jparams, tmodel, tparams, toks = pair
    S_max = S + N_DECODE
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])}, S_max,
                                use_kernels=use_kernels)
    tl, tcache = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :S]).long()},
                                S_max)
    assert _rel(tl, jl) < REL_TOL
    for t in range(N_DECODE):
        tok = toks[:, S + t]
        jl, jcache = jmodel.decode_step(jparams, jcache, {"token": jnp.asarray(tok)},
                                        use_kernels=use_kernels)
        tl, tcache = tmodel.decode_step(tparams, tcache, {"token": torch.from_numpy(tok).long()})
        assert _rel(tl, jl) < REL_TOL
    assert int(tcache["pos"]) == S + N_DECODE
    np.testing.assert_array_equal(tcache["ring_pos"].numpy(), np.asarray(jcache["ring_pos"]))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_greedy_tokens_match_repro(pair, use_kernels):
    """16 tokens after a 32-token prompt: decode wraps the 32-slot ring."""
    jmodel, jparams, tmodel, tparams, toks = pair
    from repro_torch.launch.serve import generate
    prompts = toks[:, :S]
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompts)}, S + N_GREEDY,
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


@pytest.mark.parametrize("use_kernels", [False, True])
def test_loss_matches_repro(pair, use_kernels):
    """64 tokens: the local layers' window cuts into the prompt."""
    jmodel, jparams, tmodel, tparams, toks = pair
    labels = np.roll(toks[:, :64], -1, axis=1)
    labels[:, -1] = -100
    jloss, jm = jmodel.loss(jparams, {"tokens": jnp.asarray(toks[:, :64]),
                                      "labels": jnp.asarray(labels)}, use_kernels=use_kernels)
    tloss, tm = tmodel.loss(tparams, {"tokens": torch.from_numpy(toks[:, :64]).long(),
                                      "labels": torch.from_numpy(labels).long()})
    assert abs(float(tloss) - float(jloss)) < REL_TOL
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0


@pytest.mark.parametrize("prompt", [16, 32, 40, 64])
def test_cache_matches_repro(pair, prompt):
    """Every cache tensor after the prompt. Position p sits at ring slot
    p % W in the port; repro puts the trailing W positions at slots 0..W-1,
    which is the same ring where prompt <= W or prompt % W == 0 and the
    port's ring rolled back by prompt % W otherwise."""
    jmodel, jparams, tmodel, tparams, toks = pair
    S_max = prompt + N_DECODE
    _, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :prompt])}, S_max)
    _, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :prompt]).long()},
                           S_max)
    assert set(tc) == set(jc)
    shift = prompt % W if prompt > W else 0
    for key in ("lk", "lv", "ring_pos", "gk", "gv"):
        want = np.asarray(jc[key])
        if key in ("lk", "lv", "ring_pos"):
            want = np.roll(want, shift, axis=-3 if key != "ring_pos" else 0)
        assert tc[key].shape == want.shape, key
        np.testing.assert_allclose(tc[key].numpy(), want, atol=1e-5, err_msg=key)
    assert tc["ring_pos"].dtype == torch.int32 and int(tc["pos"]) == int(jc["pos"]) == prompt
    # slot p % W holds position p for the trailing min(prompt, W) positions
    kept = np.arange(max(0, prompt - W), prompt)
    ring = np.full(W, -1)
    ring[kept % W] = kept
    np.testing.assert_array_equal(tc["ring_pos"].numpy(), ring)


@pytest.mark.parametrize("prompt", [40, 70])
def test_decode_after_wrapping_prompt_matches_full_forward(pair, prompt):
    """Prompts longer than W and not a multiple of it, where repro's ring is
    out of step (test below); the port's decode is held to its own full
    forward over the same tokens, as tests/test_models.py:73-89 does."""
    _, _, tmodel, tparams, toks = pair
    t = torch.from_numpy(toks[:, :prompt + N_DECODE]).long()
    S_max = prompt + N_DECODE
    _, cache = tmodel.prefill(tparams, {"tokens": t[:, :prompt]}, S_max)
    for i in range(N_DECODE):
        logits, cache = tmodel.decode_step(tparams, cache, {"token": t[:, prompt + i]})
        full, _ = tmodel.prefill(tparams, {"tokens": t[:, :prompt + i + 1]}, S_max)
        # tests/test_models.py:89 allows 2e-2; the two compute the same
        # function in float32, so 1e-4 holds
        assert _rel(logits, full) < REL_TOL


@pytest.mark.parametrize("prompt", [40, 70])
def test_repro_ring_is_misaligned_after_wrapping_prompt(pair, prompt):
    """The reference fault of ROADMAP Queue 3: repro's prefill puts the
    trailing W keys at slots 0..W-1 and its decode writes slot pos % W, so
    after such a prompt repro's decode is far from repro's own full forward."""
    jmodel, jparams, _, _, toks = pair
    S_max = prompt + N_DECODE
    _, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :prompt])}, S_max)
    for i in range(N_DECODE):
        jl, jc = jmodel.decode_step(jparams, jc, {"token": jnp.asarray(toks[:, prompt + i])})
    full, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks[:, :prompt + N_DECODE])},
                             S_max)
    assert _rel(jl, full) > 2e-2


@pytest.mark.parametrize("window", [None, 100])
def test_blockwise_sdpa_matches_repro_and_sdpa(window):
    """A twin of tests/test_models.py:139-147 (4 q chunks x 2 k chunks)."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 256, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 256, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 256, 2, 32)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tattn.blockwise_sdpa(tq, tk, tv, causal=True, window=window, q_chunk=64, k_chunk=128)
    want = jax_blockwise_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                              window=window, q_chunk=64, k_chunk=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    dense = tattn.sdpa(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=2e-5, rtol=2e-5)


def test_blockwise_sdpa_falls_back_when_chunks_do_not_divide(monkeypatch):
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 100, 2, 16), (1, 100, 1, 16), (1, 100, 1, 16)))
    calls = []
    real = tattn.sdpa
    monkeypatch.setattr(tattn, "sdpa", lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    got = tattn.blockwise_sdpa(q, k, v, window=30, q_chunk=64, k_chunk=64)
    assert len(calls) == 1 and calls[0]["window"] == 30
    want = jax_blockwise_sdpa(*(jnp.asarray(t.numpy()) for t in (q, k, v)), window=30,
                              q_chunk=64, k_chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_cpu_prefill_takes_blockwise_from_threshold(monkeypatch):
    """On the CPU a prefill of BLOCKWISE_THRESHOLD positions runs
    blockwise_sdpa, never the flash kernel's plain version; a shorter one
    the plain version."""
    cfg = get_smoke("qwen3-14b")
    p = build_model(cfg).init(torch.Generator().manual_seed(0))["layers"]["attn"]
    p = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict) else v[0])
         for k, v in p.items()}
    seen = []
    monkeypatch.setattr(ops, "flash_attention", lambda *a, **kw: seen.append("flash") or
                        tattn.sdpa(*a, **kw))
    real = tattn.blockwise_sdpa
    monkeypatch.setattr(tattn, "blockwise_sdpa", lambda *a, **kw: seen.append("blockwise") or
                        real(*a, **kw))
    for S in (tattn.BLOCKWISE_THRESHOLD, 64):
        x = torch.randn((1, S, cfg.d_model), generator=torch.Generator().manual_seed(S))
        tattn.attention(p, x, cfg, positions=torch.arange(S), theta=cfg.rope_theta)
    assert seen == ["blockwise", "flash"]


@pytest.mark.parametrize("pos", [5, 31, 32, 45, 100])
def test_ring_decode_matches_repro_kv_positions(pos):
    """The ring as the port keeps it (position p at slot p % W, filled up to
    and including pos) read by ops.decode_attention's plain version with
    kv_len = min(pos + 1, W), against repro's sdpa masking by the slots'
    positions with the window W."""
    rng = np.random.default_rng(pos)
    Wr, H, K, hd = 32, 4, 2, 16
    q = rng.standard_normal((2, 1, H, hd)).astype(np.float32)
    k = rng.standard_normal((2, Wr, K, hd)).astype(np.float32)
    v = rng.standard_normal((2, Wr, K, hd)).astype(np.float32)
    kept = np.arange(max(0, pos + 1 - Wr), pos + 1)
    ring_pos = np.full(Wr, -1, np.int32)
    ring_pos[kept % Wr] = kept
    want = jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=Wr,
                    q_offset=pos, kv_positions=jnp.asarray(ring_pos))
    kv_len = torch.clamp(torch.tensor(pos + 1, dtype=torch.int32), max=Wr)
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_ring_attention_writes_slot_and_reads_the_window(pair):
    """attention()'s ring mode on one local layer: k/v land at
    cache_write_pos, and the result equals repro's attention() in the same
    mode on a ring the two hold alike (prompt 32 = W)."""
    from repro.models.attention import KVCache as JKV
    from repro.models.attention import attention as jax_attention
    _, jparams, _, tparams, _ = pair
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 1, CFG.d_model)).astype(np.float32)
    ck = rng.standard_normal((B, W, CFG.n_kv_heads, CFG.hd)).astype(np.float32)
    cv = rng.standard_normal((B, W, CFG.n_kv_heads, CFG.hd)).astype(np.float32)
    pos = 45
    ring_pos = np.arange(pos - W + 1, pos + 1, dtype=np.int32)
    ring_pos = np.roll(ring_pos, (pos + 1) % W)          # slot p % W holds p
    assert ring_pos[pos % W] == pos
    jp = jax.tree.map(lambda a: a[0, 0], jparams["local_layers"]["attn"])
    tp = {k: ({kk: vv[0, 0] for kk, vv in v.items()} if isinstance(v, dict) else v[0, 0])
          for k, v in tparams["local_layers"]["attn"].items()}
    want, wc = jax_attention(jp, jnp.asarray(x), CFG, positions=jnp.asarray([pos]),
                             theta=CFG.rope_theta, window=W, cache=JKV(jnp.asarray(ck),
                                                                       jnp.asarray(cv)),
                             cache_pos=jnp.int32(pos), cache_write_pos=jnp.int32(pos % W),
                             kv_positions=jnp.asarray(ring_pos))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got, gc = tattn.attention(tp, torch.from_numpy(x), CFG, positions=torch.tensor([pos]),
                              theta=CFG.rope_theta, window=W, cache=tattn.KVCache(tk, tv),
                              cache_pos=torch.tensor(pos, dtype=torch.int32),
                              cache_write_pos=torch.tensor(pos % W, dtype=torch.int32),
                              kv_positions=torch.from_numpy(ring_pos))
    assert gc.k is tk                                    # written in place
    np.testing.assert_allclose(tk.numpy(), np.asarray(wc.k), atol=1e-5)
    assert _rel(got, want) < REL_TOL
