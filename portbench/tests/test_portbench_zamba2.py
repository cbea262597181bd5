"""The Zamba2-7B cell (``zamba2-train-s4096``) and the long-row cell
(``phi4-train-s8192``) at small sizes on the CPU: the reference's layout is
the program's tree, key for key and shape for shape; its model FLOPs against
PyTorch's own count of the reference's products; the grouped SSD work counts
against a count by hand; a whole run of each cell's kind, program against
reference; the long-row kind's recomputed attention giving the readings of
the plain one; and the configuration file's published keys against the
program's."""

import contextlib
import dataclasses
import importlib
import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import check, generate, harness, peaks, trace, weights
from portbench.kinds import train, train_long, train_sliced
from portbench.reference.layout import flatten, unflatten
from portbench.reference.ops import Products

KERNELS = trace.kernel_modules()

# the published widths cut to a CPU test's size, under the configuration's
# own keys (the program's chunk 16, the reference's 32)
SMALL = dict(n_layers=8, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32, attn_in=128,
             d_ff=128, vocab_size=256, ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
             chunk_size=32, hybrid_layer_ids=[1, 3, 5, 7], adapter_rank=8)


def small_zamba2(dtype: str = "float32") -> harness.Cell:
    cell = harness.Cell.load("zamba2-train-s4096")
    tr = {**cell.traffic, "batch": 2, "seq": 64, "max_steps_per_s": 400, "shard_tokens": 4096,
          "documents": {**cell.traffic["documents"], "median_tokens": 40, "min_tokens": 4,
                        "max_tokens": 200}}
    return dataclasses.replace(cell, config={**cell.config, **SMALL, "dtype": dtype},
                               traffic=tr)


def small_phi4_long() -> harness.Cell:
    cell = harness.Cell.load("phi4-train-s8192")
    cfg = {**cell.config, "n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
           "head_dim": 16, "d_ff": 128, "vocab_size": 512, "dtype": "float32"}
    tr = {**cell.traffic, "seq": 256, "max_steps_per_s": 400, "shard_tokens": 4096,
          "documents": {**cell.traffic["documents"], "median_tokens": 128, "min_tokens": 8,
                        "max_tokens": 2048}}
    return dataclasses.replace(cell, config=cfg, traffic=tr)


def test_layout_is_the_programs():
    from repro_torch.models import build_model
    cell = small_zamba2("bfloat16")
    got = {p: (tuple(t.shape), t.dtype) for p, t in
           flatten(build_model(harness.model_config(cell.config)).init(
               torch.Generator().manual_seed(0)))}
    want = {p: (tuple(t.shape), t.dtype) for p, t in weights.make(
        cell.family.param_spec(cell.config), 3, torch.device("cpu"), "bfloat16",
        cell.config["init"]).items()}
    assert got == want


def test_layout_at_the_cells_size():
    """2.733 G parameters at the cut: 24 mamba layers of 78.44 M, two shared
    blocks of 333.98 M, four adapters of 4.13 M and four site linears of
    12.85 M, and the 114.7 M-row embedding (shapes only)."""
    cell = harness.Cell.load("zamba2-train-s4096")
    n = {p: int(np.prod(lf.shape)) for p, lf in flatten(cell.family.param_spec(cell.config))}

    def total(prefix):
        return sum(v for p, v in n.items() if p.startswith(prefix))
    assert total("layers/") / 24 == pytest.approx(78.44e6, rel=1e-3)
    assert total("shared/") / 2 == pytest.approx(333.98e6, rel=1e-3)
    assert total("adapters/") / 4 == pytest.approx(4.13e6, rel=1e-3)
    assert total("linear/") / 4 == pytest.approx(12.85e6, rel=1e-3)
    assert total("embed/") == 32000 * 3584
    assert sum(n.values()) == pytest.approx(2.7332e9, rel=1e-3)


def test_model_flops_match_pytorchs_count_of_the_reference():
    """3 times the forward's products as FlopCounterMode counts them on the
    reference (one row, every product, the conv included), less half of the
    causal products the model_flops convention halves (Q.K^T and P.V, and
    the SSD's C.B^T and M.x within a chunk), which the reference computes
    whole."""
    cell = small_zamba2()
    cfg = cell.config
    S = 64
    w = weights.make(cell.family.param_spec(cfg), 3, torch.device("cpu"), "float32", cfg["init"])
    tokens = torch.zeros((1, S), dtype=torch.long)
    with torch.no_grad(), FlopCounterMode(display=False) as count:
        cell.family.nll_sum(unflatten(w.items()), tokens, tokens, cfg, Products("float32"))
    H, hd, L, ns = cfg["n_heads"], cfg["head_dim"], cfg["n_layers"], len(cfg["hybrid_layer_ids"])
    Q, N, G = cfg["chunk_size"], cfg["ssm_state"], cfg["ssm_groups"]
    Hm, P = cfg["ssm_expand"] * cfg["d_model"] // cfg["ssm_head_dim"], cfg["ssm_head_dim"]
    whole_attention = ns * 2 * (2 * S * S * H * hd)
    whole_in_chunk = L * (S // Q) * (2 * Q * Q * N * G + 2 * Q * Q * Hm * P)
    want = 3 * (count.get_total_flops() - whole_attention / 2 - whole_in_chunk / 2)
    assert cell.family.model_flops(cfg, 1, S) == pytest.approx(want, rel=1e-12)


def test_cell_model_flops_match_a_count_by_hand():
    """At the cut, B 2 x S 4096: weights and attention by hand (a mamba layer
    78.42 M weights in products with its conv, a site 333.98 M of its block
    less its norms, its adapter and linear, the tied output projection),
    172.9 TFLOP a step; the SSD's own products in chunks of 256, 2.18 more."""
    cell = harness.Cell.load("zamba2-train-s4096")
    L, ns, tokens, S = 24, 4, 2 * 4096, 4096
    d, di, GN, H, W = 3584, 7168, 2 * 64, 112, 4
    mixer = d * (2 * di + 2 * GN + H) + di * d + W * (di + 2 * GN)
    site = 7168 * 3 * 7168 + 7168 * d + 3 * d * 14336 + 128 * (d + 2 * 14336) + d * d
    weights = L * mixer + ns * site + d * 32000
    attention = ns * 2 * 32 * 224 * S
    Q, N, G, P = 256, 64, 2, 64
    ssd = L * (Q * N * G + Q * H * P + 4 * H * P * N)
    got = cell.family.model_flops(cell.config, 2, S)
    assert got == pytest.approx(3 * (2 * weights + attention + ssd) * tokens, rel=1e-12)
    assert 3 * (2 * weights + attention) * tokens == pytest.approx(172.9e12, rel=1e-3)
    assert 3 * ssd * tokens == pytest.approx(2.184e12, rel=1e-3)


def test_grouped_ssd_work_matches_a_count_by_hand():
    """At Zamba2-7B's training shape (2 rows of 16 chunks of Q 128, 112
    heads in 2 groups, N = P = 64): bytes and
    3xTF32 products by hand; C and B of G groups count G times the bytes and
    C.B^T's products; a (B, nc, Q, N) call counts as one group."""
    def meta(*s):
        return torch.empty(s, dtype=torch.float32, device="meta")
    BC, Q, H, N, P, G = 32, 128, 112, 64, 64, 2
    tri = Q * (Q + 1) // 2
    la, x = meta(2, 16, Q, H), meta(2, 16, Q, H, P)
    C = meta(2, 16, Q, G, N)
    nbytes, ops = KERNELS["ssd_intra_chunk"].work(la, C, C, x)
    assert nbytes == 4 * (BC * Q * H + 2 * BC * Q * G * N + 2 * BC * Q * H * P
                          + BC * H * P * N + BC * H)
    assert ops["tf32"] == 3 * (2 * BC * G * N * tri + 2 * BC * H * P * tri
                               + 2 * BC * H * Q * P * N)
    bnbytes, bops = KERNELS["ssd_intra_chunk_bwd"].work(la, C, C, x, x, meta(2, 16, H, P, N),
                                                        meta(2, 16, H))
    assert bnbytes == 4 * (2 * BC * Q * H + 4 * BC * Q * G * N + 3 * BC * Q * H * P
                           + BC * H * P * N + BC * H)
    assert bops["tf32"] == 3 * (6 * BC * G * N * tri + 4 * BC * H * P * tri
                                + 4 * BC * H * Q * P * N)
    one = meta(2, 16, Q, N)
    assert KERNELS["ssd_intra_chunk"].work(la, one, one, x) == \
        KERNELS["ssd_intra_chunk"].work(la, meta(2, 16, Q, 1, N), meta(2, 16, Q, 1, N), x)
    # the bound: bytes at this shape (PERF.md's kernel table, zamba2 train)
    ms, by = peaks.bound_ms(bnbytes, bops)
    assert by == "bytes" and ms == pytest.approx(bnbytes / peaks.HBM_BYTES_PER_S * 1e3)


def kind_reference(cell: harness.Cell):
    """The reference as the cell's kind runs it."""
    return {"train_long": train_long.recomputed_attention,
            "train_sliced": train_sliced.sliced_update}.get(cell.traffic["kind"],
                                                            contextlib.nullcontext)()


@pytest.mark.parametrize("make", [small_zamba2, small_phi4_long], ids=["zamba2", "phi4-long"])
def test_first_steps_match_the_reference_in_float32(make):
    """The program's three first steps against the reference's, through the
    cell's own kind, at a small size in float32: every number far inside
    the cell's limits."""
    cell = make()
    seed = 2**31 + 13
    tokens = generate.corpus(cell.traffic, cell.config["vocab_size"], seed,
                             generate.steps_for(cell.traffic, 0))
    prog = train.Program(cell, seed, torch.device("cpu"), tokens)
    try:
        got = prog.first_steps()
    finally:
        prog.close()
    with kind_reference(cell):
        want = train.reference_readings(cell, seed, torch.device("cpu"), tokens)
    gaps = check.gaps(got, want)
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4 and gaps["change_gap"] < 1e-4, gaps


def test_long_rows_recomputed_give_the_plain_readings():
    """The long-row kind's reference, attention recomputed in the backward,
    reads what the plain one reads, bit for bit; and the kind restores the
    reference's attention afterwards."""
    from portbench.reference import ops
    cell = small_phi4_long()
    seed = 2**31 + 17
    tokens = generate.corpus(cell.traffic, cell.config["vocab_size"], seed,
                             generate.steps_for(cell.traffic, 0))
    plain = ops.causal_attention
    want = train.reference_readings(cell, seed, torch.device("cpu"), tokens)
    with train_long.recomputed_attention():
        assert ops.causal_attention is not plain
        got = train.reference_readings(cell, seed, torch.device("cpu"), tokens)
    assert ops.causal_attention is plain
    assert got == want


def test_a_whole_run_of_each_kind_on_the_cpu():
    """``kinds.<kind>.run`` end to end at a small size: correct, steps taken,
    the checks under their limits."""
    import time
    for cell in (small_zamba2(), small_phi4_long()):
        cell = dataclasses.replace(cell, limits={"loss_gap": 1e-4, "grad_gap": 1e-3,
                                                 "change_gap": 1e-3})
        kind = importlib.import_module(f"portbench.kinds.{cell.traffic['kind']}")
        out = kind.run(cell, 2**31 + 19, 0.2, False, torch.device("cpu"), time.perf_counter())
        assert out["correct"] and out["attempted"] > 0, out["checks"]


def test_config_files_published_keys_agree_with_the_programs():
    """The configuration file holds the catalog's keys (cut where ``reduced``
    says) beside the program's own; where both say a number they agree."""
    cfg = harness.Cell.load("zamba2-train-s4096").config
    same = {"hidden_size": "d_model", "num_hidden_layers": "n_layers",
            "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
            "attention_head_dim": "head_dim", "attention_hidden_size": "attn_in",
            "intermediate_size": "d_ff", "mamba_d_state": "ssm_state",
            "mamba_headdim": "ssm_head_dim", "mamba_expand": "ssm_expand",
            "mamba_d_conv": "ssm_conv_width", "mamba_ngroups": "ssm_groups",
            "num_mem_blocks": "n_shared_blocks", "rms_norm_eps": "norm_eps"}
    for published, ours in same.items():
        assert cfg[published] == cfg[ours], published
    assert cfg["hybrid_layer_ids"] == [i for i, t in enumerate(cfg["layers_block_type"])
                                       if t == "hybrid"]
    assert len(cfg["layers_block_type"]) == cfg["n_layers"] == cfg["num_hidden_layers"] == 24
    assert cfg["hidden_act"] == "gelu"
    assert cfg["n_mamba_heads"] == cfg["ssm_expand"] * cfg["d_model"] // cfg["ssm_head_dim"]
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in spec["configs"] if c["name"] == "zamba2-7b-l24")
    assert entry["reduced"] == cfg["reduced"] and entry["source"] == cfg["source"]


def test_sliced_reference_update_is_the_whole_leaf_update(monkeypatch):
    """``kinds/train_sliced``: the reference's AdamW on slices of the leaves
    (here 7 elements, so leaves split unevenly) moves the weights and both
    moments as on whole leaves, with the clip active; and the plain update
    is back in place after the block."""
    from portbench.kinds import train_sliced
    from portbench.reference import adamw
    monkeypatch.setattr(train_sliced, "SLICE", 7)
    g = torch.Generator().manual_seed(5)
    shapes = [(3, 5), (11,), (2, 3, 4)]

    def make(scale=1.0):
        return [torch.randn(s, generator=g) * scale for s in shapes]
    params, grads, m = make(), make(3.0), make(0.1)
    v = [t.abs() for t in make(0.1)]
    opt = {"lr": 1e-2, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "grad_clip": 1.0}
    want = [[t.clone() for t in ts] for ts in (params, m, v)]
    plain = adamw.update
    plain(*want[:1], grads, *want[1:], 2, opt)
    with train_sliced.sliced_update():
        adamw.update(params, grads, m, v, 2, opt)
    assert adamw.update is plain
    for got, exp in zip((params, m, v), want):
        for a, b in zip(got, exp):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
