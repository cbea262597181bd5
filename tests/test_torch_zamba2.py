"""Zamba2-7B (family ``"zamba2"``) on the CPU at a small size: the port's
loss and every gradient against the benchmark's plain float32 reference
(``portbench/reference/zamba2.py``) from the same seeded weights; the
reference's logits against transformers' ``Zamba2ForCausalLM`` with the
weights carried across, which pins the equations (the (hd/2)^-1/2 scale, the
concatenation's order, the adapters' indexing, the residual taken before the
shared output is added, the grouped gated norm, the blocks' alternation);
the grouped SSD's plain version against its groups one at a time; the
inter-chunk scan in one product against the chunk loop; and the published
configuration's numbers."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import weights  # noqa: E402
from portbench.reference import zamba2 as reference  # noqa: E402
from portbench.reference.layout import flatten, unflatten  # noqa: E402
from portbench.reference.ops import Products  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

# d 64, 2 B/C groups of 4 heads, both shared blocks used twice inside 8
# layers, attention 128 wide in 4 heads of 32; the program's chunk 16, the
# reference's 32 (the cell's 128 against the published 256)
SMALL = dict(name="zamba2-small", family="zamba2", n_layers=8, d_model=64, n_heads=4,
             n_kv_heads=4, head_dim=32, attn_in=128, attn_scale_div=2, d_ff=128,
             vocab_size=256, rope_theta=10000.0, norm_eps=1e-5, tie_embeddings=True,
             ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_conv_width=4, ssm_chunk=16,
             ssm_groups=2, chunk_size=32, n_shared_blocks=2, hybrid_layer_ids=[1, 3, 5, 7],
             adapter_rank=8, dtype="float32",
             init={"time_step_min": 1e-3, "time_step_max": 0.1, "time_step_floor": 1e-4,
                   "A_init_range": [1, 16]})


def model_config(cfg: dict) -> ModelConfig:
    import dataclasses
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in names})


def made_weights(cfg: dict, seed: int = 3) -> dict:
    return weights.make(reference.param_spec(cfg), seed, torch.device("cpu"), cfg["dtype"],
                        cfg["init"])


def batch(cfg: dict, S: int = 70, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, cfg["vocab_size"], (2, S), generator=g),
            torch.randint(0, cfg["vocab_size"], (2, S), generator=g))


def test_layout_is_the_programs():
    cfg = {**SMALL, "dtype": "bfloat16"}
    got = {p: (tuple(t.shape), t.dtype) for p, t in
           flatten(build_model(model_config(cfg)).init(torch.Generator().manual_seed(0)))}
    want = {p: (tuple(t.shape), t.dtype) for p, t in made_weights(cfg).items()}
    assert got == want


@pytest.mark.parametrize("remat", [None, "full"])
@pytest.mark.parametrize("S", [70, 96])
def test_loss_and_grads_match_the_reference(remat, S):
    """float32 on both sides, the program in chunks of 16 and the reference
    of 32 (S 70 pads the last of each; S 96 fills them): the loss within
    1e-6 relative and every leaf's gradient within 1e-4 of its max, the
    float32 rounding of two orders of summation."""
    cfg = SMALL
    w = made_weights(cfg)
    tokens, labels = batch(cfg, S)
    prog = {p: t.clone().requires_grad_(True) for p, t in w.items()}
    loss, _ = build_model(model_config(cfg)).loss(unflatten(prog.items()),
                                                  {"tokens": tokens, "labels": labels},
                                                  remat=remat)
    loss.backward()
    ref = {p: t.clone().requires_grad_(True) for p, t in w.items()}
    nll = reference.nll_sum(unflatten(ref.items()), tokens, labels, cfg, Products("float32"))
    (nll / labels.numel()).backward()
    assert float(loss) == pytest.approx(float(nll) / labels.numel(), rel=1e-6)
    for p in w:
        want = ref[p].grad
        scale = float(want.abs().max()) or 1.0
        assert float((prog[p].grad - want).abs().max()) <= 1e-4 * scale, p


def _hf_model(cfg: dict, w: dict, hf_chunk: int):
    """transformers' Zamba2ForCausalLM at ``cfg`` with the weights ``w``
    carried across (nn.Linear holds the transpose of the program's (in, out)
    products; the conv's weight is (channels, 1, width)), its SSD in chunks
    of ``hf_chunk``."""
    transformers = pytest.importorskip("transformers")
    L = cfg["n_layers"]
    kinds = ["hybrid" if i in cfg["hybrid_layer_ids"] else "mamba" for i in range(L)]
    di = cfg["ssm_expand"] * cfg["d_model"]
    hf_cfg = transformers.Zamba2Config(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["d_model"], num_hidden_layers=L,
        layers_block_type=kinds, mamba_d_state=cfg["ssm_state"],
        mamba_d_conv=cfg["ssm_conv_width"], mamba_expand=cfg["ssm_expand"],
        mamba_ngroups=cfg["ssm_groups"], n_mamba_heads=di // cfg["ssm_head_dim"],
        chunk_size=hf_chunk, intermediate_size=cfg["d_ff"], hidden_act="gelu",
        num_attention_heads=cfg["n_heads"], num_key_value_heads=cfg["n_kv_heads"],
        num_mem_blocks=cfg["n_shared_blocks"], use_shared_attention_adapter=False,
        adapter_rank=cfg["adapter_rank"], use_mem_rope=True, rope_theta=cfg["rope_theta"],
        rms_norm_eps=cfg["norm_eps"], tie_word_embeddings=True)
    hf_cfg._attn_implementation = "eager"
    assert hf_cfg.attention_hidden_size == cfg["attn_in"]
    assert hf_cfg.attention_head_dim == cfg["head_dim"]
    model = transformers.Zamba2ForCausalLM(hf_cfg).eval()
    t = {p: v.detach() for p, v in w.items()}
    sd = {"model.embed_tokens.weight": t["embed/w"],
          "model.final_layernorm.weight": t["final_norm/scale"]}
    site = {lid: k for k, lid in enumerate(cfg["hybrid_layer_ids"])}
    for i in range(L):
        k = site.get(i)
        pre = f"model.layers.{i}." + ("mamba_decoder." if k is not None else "")
        lw = {name: t[f"layers/{name}"][i] for name in
              ("norm/scale", "mamba/in_proj/w", "mamba/conv_w", "mamba/conv_b", "mamba/dt_bias",
               "mamba/A_log", "mamba/D", "mamba/gnorm/scale", "mamba/out_proj/w")}
        sd.update({pre + "input_layernorm.weight": lw["norm/scale"],
                   pre + "mamba.in_proj.weight": lw["mamba/in_proj/w"].T,
                   pre + "mamba.conv1d.weight": lw["mamba/conv_w"].T[:, None, :],
                   pre + "mamba.conv1d.bias": lw["mamba/conv_b"],
                   pre + "mamba.dt_bias": lw["mamba/dt_bias"],
                   pre + "mamba.A_log": lw["mamba/A_log"], pre + "mamba.D": lw["mamba/D"],
                   pre + "mamba.norm.weight": lw["mamba/gnorm/scale"],
                   pre + "mamba.out_proj.weight": lw["mamba/out_proj/w"].T})
        if k is None:
            continue
        b = k % cfg["n_shared_blocks"]
        st = f"model.layers.{i}.shared_transformer."
        sd.update({f"model.layers.{i}.linear.weight": t["linear/w"][k].T,
                   st + "input_layernorm.weight": t["shared/ln1/scale"][b],
                   st + "pre_ff_layernorm.weight": t["shared/ln2/scale"][b],
                   st + "feed_forward.gate_up_proj.weight": t["shared/mlp/gate_up/w"][b].T,
                   st + "feed_forward.down_proj.weight": t["shared/mlp/down/w"][b].T})
        # a block's adapter list holds the adapters of every site it serves,
        # at the site's index; each site's layer names the block's whole list
        for j in range(b, len(site), cfg["n_shared_blocks"]):
            sd[st + f"feed_forward.gate_up_proj_adapter_list.{j}.0.weight"] = \
                t["adapters/a/w"][j].T
            sd[st + f"feed_forward.gate_up_proj_adapter_list.{j}.1.weight"] = \
                t["adapters/b/w"][j].T
        for name in ("q", "k", "v", "o"):
            sd[st + f"self_attn.{name}_proj.weight"] = t[f"shared/attn/w{name}/w"][b].T
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected and set(missing) <= {"lm_head.weight"}, (missing, unexpected)
    for layer in model.model.layers:
        mixer = getattr(layer, "mamba_decoder", layer).mamba
        # transformers' plain path clamps dt at time_step_min, its kernel path
        # (dt_limit from time_step_limit, null) does not; the port and the
        # reference follow the kernel path
        mixer.time_step_min = 0.0
    return model


@pytest.mark.parametrize("S", [64, 75])
def test_reference_matches_transformers_zamba2(S):
    """The reference's logits against transformers' at the same small config
    and weights, within 2e-5 of their largest magnitude: both float32,
    summed in other orders (einsums against transformers' broadcast sums).
    transformers' plain path (4.57) carries the SSD's states across chunks
    wrongly (it sums the chunks' decays over the chunk they flow into), so it
    takes the whole row as one chunk; the reference runs in chunks of 32 (S
    75 pads the last), and its carry is held to the sequential recurrence by
    the next test."""
    cfg = SMALL
    w = made_weights(cfg)
    model = _hf_model(cfg, w, hf_chunk=128)
    tokens, _ = batch(cfg, S)
    with torch.no_grad():
        want = model(tokens, use_cache=False).logits
        got = reference.hidden(unflatten(w.items()), tokens, cfg, Products("float32")) \
            @ w["embed/w"].T
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 2e-5 * float(want.abs().max())


@pytest.mark.parametrize("G", [1, 2])
def test_reference_ssd_is_the_recurrence(G):
    """The reference's chunked SSD (chunks of 16 over 50 steps, the last
    padded) against the recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,
    y_t = h_t C_t, one step at a time, head h reading group h // (H/G)."""
    g = torch.Generator().manual_seed(6)
    b, S, H, P, N = 2, 50, 4, 8, 16
    x, C, Bm = (torch.randn(s, generator=g) for s in ((b, S, H, P), (b, S, G, N), (b, S, G, N)))
    dt = torch.rand((b, S, H), generator=g) * 0.2
    A = -torch.rand(H, generator=g) * 4
    grp = torch.arange(H) // (H // G)
    h, want = torch.zeros(b, H, P, N), []
    for t in range(S):
        h = torch.exp(dt[:, t, :, None, None] * A[:, None, None]) * h \
            + dt[:, t, :, None, None] * x[:, t, :, :, None] * Bm[:, t, grp, None, :]
        want.append(torch.einsum("bhpn,bhn->bhp", h, C[:, t, grp]))
    got = reference.ssd(x, dt, A, Bm, C, 16, Products("float32"))
    torch.testing.assert_close(got, torch.stack(want, 1), rtol=1e-5, atol=1e-5)


def test_the_reference_tells_a_changed_equation_apart():
    """The comparison above is tight enough to see the equations it pins:
    the plain hd^-1/2 scale, the two blocks used in the other order, and
    each site given the other block's adapter of its pair each move the
    logits by over 100 times its tolerance."""
    cfg = SMALL
    w = made_weights(cfg)
    tokens, _ = batch(cfg, 64)
    params = unflatten(w.items())

    def logits(c, p):
        with torch.no_grad():
            return reference.hidden(p, tokens, c, Products("float32")) @ w["embed/w"].T
    base = logits(cfg, params)
    changed = [logits({**cfg, "attn_scale_div": 1}, params),
               logits(cfg, {**params, "shared": flip_leading(params["shared"])}),
               logits(cfg, {**params, "adapters": flip_pairs(params["adapters"])})]
    for got in changed:
        assert float((got - base).abs().max()) > 100 * 2e-5 * float(base.abs().max())


def flip_leading(tree):
    if isinstance(tree, dict):
        return {k: flip_leading(v) for k, v in tree.items()}
    return tree.flip(0)


def flip_pairs(tree):
    """Sites 0, 1, 2, 3 -> 1, 0, 3, 2: each site given the other block's
    adapter of its pair."""
    if isinstance(tree, dict):
        return {k: flip_pairs(v) for k, v in tree.items()}
    return tree[[1, 0, 3, 2]]


def test_grouped_ssd_plain_matches_its_groups_one_at_a_time():
    """``ssd_intra_chunk_plain`` with C and B in 2 groups gives, for each
    group's heads, what the one-group version gives on that group's C and B
    and those heads alone."""
    from repro_torch.kernels.ssd_scan import ssd_intra_chunk_plain
    g = torch.Generator().manual_seed(4)
    B, nc, Q, H, N, P, G = 2, 3, 16, 6, 8, 4, 2
    la = -torch.nn.functional.softplus(torch.randn((B, nc, Q, H), generator=g))
    C, Bm = torch.randn((B, nc, Q, G, N), generator=g), torch.randn((B, nc, Q, G, N), generator=g)
    x = torch.randn((B, nc, Q, H, P), generator=g)
    y, st, tot = ssd_intra_chunk_plain(la, C, Bm, x)
    per = H // G
    for k in range(G):
        hs = slice(k * per, (k + 1) * per)
        want = ssd_intra_chunk_plain(la[..., hs], C[:, :, :, k:k + 1], Bm[:, :, :, k:k + 1],
                                     x[:, :, :, hs])
        for a, b in zip((y[:, :, :, hs], st[:, :, hs], tot[:, :, hs]), want):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("nc,depth", [(9, 40.0), (139, 0.5)])
@pytest.mark.parametrize("recorded", [False, True], ids=["loop", "product"])
def test_carry_states_is_the_chunk_loop(with_h0, nc, depth, recorded):
    """``mamba2.carry_states`` (the inter-chunk scan: under autograd one
    product a block of up to 64 chunks, else the chunk loop) gives the states
    the chunk loop gives, entering each chunk and at the end, and under
    autograd the same gradients, in float64 to 1e-12: 9 chunks with total
    log decays down to -40 a chunk, and 139 chunks (blocks of 64 + 64 + 11)
    with decays down to -0.5 a chunk, so that states cross the blocks'
    seams."""
    from repro_torch.models.mamba2 import carry_states
    g = torch.Generator().manual_seed(8)
    B, H, P, N = 2, 3, 4, 5
    states = torch.randn((B, nc, H, P, N), generator=g, dtype=torch.float64)
    tot = -torch.rand((B, nc, H), generator=g, dtype=torch.float64) * depth
    h0 = torch.randn((B, H, P, N), generator=g, dtype=torch.float64) if with_h0 \
        else torch.zeros((B, H, P, N), dtype=torch.float64)
    for t in (states, tot, h0):
        t.requires_grad_(recorded)
    h, want = h0, []
    for c in range(nc):
        want.append(h)
        h = torch.exp(tot[:, c])[:, :, None, None] * h + states[:, c]
    want = torch.stack(want, 1)
    got, end = carry_states(states, tot, h0)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(end, h, rtol=1e-12, atol=1e-12)
    if recorded:
        w, w_end = torch.randn_like(want), torch.randn_like(h)
        leaves = (states, tot, h0)
        got_g = torch.autograd.grad((got * w).sum() + (end * w_end).sum(), leaves)
        want_g = torch.autograd.grad((want * w).sum() + (h * w_end).sum(), leaves)
        for a, b in zip(got_g, want_g):
            torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)


def test_published_config():
    """The configuration as published: 81 layers, 13 hybrid sites over two
    blocks, attention 7168 -> 32 x 224 at (224/2)^-1/2, 2 groups of 56 SSM
    heads, 7168 inner, a rank-128 adapter; and the port's plain path builds
    and trains the smoke configuration."""
    from repro_torch.configs.zamba2_7b_instruct import CONFIG, SMOKE
    assert (CONFIG.n_layers, CONFIG.d_model, CONFIG.attn_in, CONFIG.hd) == (81, 3584, 7168, 224)
    assert CONFIG.hybrid_layer_ids[:4] == (6, 11, 17, 23) and len(CONFIG.hybrid_layer_ids) == 13
    assert (CONFIG.n_ssm_heads, CONFIG.d_inner_ssm, CONFIG.ssm_groups) == (112, 7168, 2)
    assert (CONFIG.adapter_rank, CONFIG.d_ff, CONFIG.vocab_size) == (128, 14336, 32000)
    model = build_model(SMOKE)
    params = model.init(torch.Generator().manual_seed(0))
    tok = torch.randint(0, SMOKE.vocab_size, (1, 40), generator=torch.Generator().manual_seed(1))
    loss, _ = model.loss(params, {"tokens": tok, "labels": tok}, remat="full")
    assert torch.isfinite(loss)
    with pytest.raises(NotImplementedError):
        model.prefill(params, {"tokens": tok}, 64)
