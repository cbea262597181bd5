"""The frozen work counts and the model-FLOP count, on the CPU (shapes on
the meta device), against the bounds of PERF.md's kernel table and a
count by hand; and that every name BENCHMARK.json gives has its file."""

import json
import os

import pytest
import torch

from portbench import check, harness, peaks, trace
from portbench.kernels import flash_attention

ROOT = harness.ROOT
KERNELS = trace.kernel_modules()


def meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def f32(*shape):
    return meta(*shape, dtype=torch.float32)


# (kernel, arguments, keywords, PERF.md's bound in ms, what sets it)
TABLE = [
    ("rmsnorm", (meta(4096, 5120), meta(5120)), {}, 0.02504, "bytes"),
    ("rmsnorm", (meta(8192, 3072), meta(3072)), {}, 0.03005, "bytes"),
    ("rmsnorm_bwd", (meta(8192, 3072), meta(3072), meta(8192, 3072), f32(8192)), {},
     0.04509, "bytes"),
    ("flash_attention", (meta(4, 2048, 24, 128), meta(4, 2048, 8, 128), meta(4, 2048, 8, 128)),
     {"causal": True, "return_lse": True}, 0.1043, "operations"),
    ("flash_attention", (meta(8, 512, 40, 128), meta(8, 512, 8, 128), meta(8, 512, 8, 128)),
     {"causal": True}, 0.03005, "bytes"),
    ("flash_attention_bwd", (meta(4, 2048, 24, 128), meta(4, 2048, 8, 128),
                             meta(4, 2048, 8, 128), meta(4, 2048, 24, 128), f32(4, 24, 2048),
                             meta(4, 2048, 24, 128)), {"causal": True}, 0.2607, "operations"),
    ("flash_attention_bwd", (meta(4, 2048, 32, 112), meta(4, 2048, 32, 112),
                             meta(4, 2048, 32, 112), meta(4, 2048, 32, 112), f32(4, 32, 2048),
                             meta(4, 2048, 32, 112)), {"causal": True}, 0.3041, "operations"),
]


@pytest.mark.parametrize("kernel,args,kwargs,want,by", TABLE,
                         ids=[f"{k}-{i}" for i, (k, *_) in enumerate(TABLE)])
def test_bound_matches_the_kernel_table(kernel, args, kwargs, want, by):
    ms, got_by = peaks.bound_ms(*KERNELS[kernel].work(*args, **kwargs))
    assert got_by == by
    assert ms == pytest.approx(want, rel=5e-4)


def test_training_forward_counts_its_inverse_rms():
    x, s = meta(8192, 3072), meta(3072)
    plain, _ = KERNELS["rmsnorm"].work(x, s)
    training, _ = KERNELS["rmsnorm"].work(x, s, eps=1e-5, return_inv=True)
    assert training - plain == 4 * 8192


@pytest.mark.parametrize("S,T,causal,window", [(2048, 2048, True, None), (17, 17, True, None),
                                               (1000, 1000, True, 100), (65, 65, True, 64),
                                               (129, 257, False, None), (300, 65, True, None)])
def test_valid_pairs_match_a_count_of_the_mask(S, T, causal, window):
    rows = torch.arange(S)[:, None]
    cols = torch.arange(T)[None, :]
    ok = (cols <= rows) if causal else torch.ones((S, T), dtype=torch.bool)
    if window is not None:
        ok &= cols > rows - window
    assert flash_attention.pairs(S, T, causal, window) == int(ok.sum())


def test_phi4_model_flops_match_a_count_by_hand():
    cell = harness.Cell.load("phi4-train-s2048")
    # a layer: q and o 3072 x 3072, k and v 3072 x 1024, the MLP 3 x 3072 x 8192
    layer = 2 * 3072 * 3072 + 2 * 3072 * 1024 + 3 * 3072 * 8192
    weights = 8 * layer + 3072 * 200_064          # the tied output projection, no embedding lookup
    tokens = 4 * 2048
    attention = 6 * 8 * 24 * 128 * 2048 * tokens  # causal Q.K^T and P.V, forward and backward
    want = 6 * weights * tokens + attention
    assert want == pytest.approx(7.2e13, rel=1e-2)       # the issue's estimate
    got = cell.family.model_flops(cell.config, cell.traffic["batch"], cell.traffic["seq"])
    assert got == pytest.approx(want, rel=1e-12)


def test_every_name_in_the_benchmark_has_its_file():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists(), m["name"]
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["name"].split(".")[0][:-len("_roofline")] in KERNELS, m["name"]
    for c in spec["configs"]:
        assert os.path.exists(ROOT / c["file"]), c["file"]
    for w in spec["workloads"]:
        limits = harness.Cell.load(w["name"]).limits
        assert set(limits) <= set(check.NUMBERS), w["name"]
        assert any(v is not None for v in limits.values()), w["name"]
