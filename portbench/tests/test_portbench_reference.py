"""The plain float32 references against the port's plain path (its kernels'
plain versions on the CPU) at small sizes, from the same weights and batch:
the parameter layout, the loss, every gradient, one AdamW update, and the
three first steps as the check reads them."""

import numpy as np
import pytest
import torch

from portbench.kinds import train
from portbench import check, generate, harness, weights
from portbench.reference import adamw
from portbench.reference.layout import Leaf, flatten, unflatten
from portbench.reference.ops import Products

from small import small_cell

CELLS = ("phi4-train-s2048",)


def program_model(cell):
    from repro_torch.models import build_model
    return build_model(harness.model_config(cell.config))


def made_weights(cell, seed=3):
    spec = cell.family.param_spec(cell.config)
    return weights.make(spec, seed, torch.device("cpu"), cell.config["dtype"],
                        cell.config.get("init"))


def first_batch(cell, seed=3):
    tokens = generate.corpus(cell.traffic, cell.config["vocab_size"], seed, 2)
    t, lab = generate.batch(tokens, cell.traffic, 0)
    return torch.from_numpy(t.astype(np.int64)), torch.from_numpy(lab.astype(np.int64))


@pytest.mark.parametrize("name", CELLS)
def test_layout_is_the_programs(name):
    cell = small_cell(name, dtype="bfloat16")
    model = program_model(cell)
    got = {p: (tuple(t.shape), t.dtype)
           for p, t in flatten(model.init(torch.Generator().manual_seed(0)))}
    want = {p: (tuple(t.shape), t.dtype) for p, t in made_weights(cell).items()}
    assert got == want


@pytest.mark.parametrize("name", CELLS)
def test_loss_and_grads_match_the_program(name):
    cell = small_cell(name, dtype="float32")
    w = made_weights(cell)
    tokens, labels = first_batch(cell)
    model = program_model(cell)
    prog = {p: t.clone().requires_grad_(True) for p, t in w.items()}
    loss, _ = model.loss(unflatten(prog.items()), {"tokens": tokens, "labels": labels})
    loss.backward()
    ref = {p: t.clone().requires_grad_(True) for p, t in w.items()}
    nll = cell.family.nll_sum(unflatten(ref.items()), tokens, labels, cell.config,
                              Products("float32"))
    (nll / labels.numel()).backward()
    assert float(nll.detach()) / labels.numel() == pytest.approx(float(loss.detach()), rel=1e-6)
    for p in w:
        g, want = prog[p].grad, ref[p].grad
        scale = float(want.abs().max()) or 1.0
        assert float((g - want).abs().max()) <= 1e-4 * scale, p


def test_adamw_matches_the_programs():
    from repro_torch.optim import AdamWConfig, init, update
    cell = small_cell("phi4-train-s2048", dtype="float32")
    w = made_weights(cell)
    gen = torch.Generator().manual_seed(5)
    grads = {p: torch.randn(t.shape, generator=gen) * 1e-2 for p, t in w.items()}
    params = unflatten((p, t.clone()) for p, t in w.items())
    state = init(params)
    opt = cell.optimizer
    for _ in range(2):
        params, state, _ = update(unflatten(grads.items()), state, params, AdamWConfig(**opt))
    mine = [w[p].clone() for p in sorted(w)]
    m = [torch.zeros_like(t) for t in mine]
    v = [torch.zeros_like(t) for t in mine]
    for step in (1, 2):
        adamw.update(mine, [grads[p] for p in sorted(w)], m, v, step, opt)
    for (p, got), want in zip(flatten(params), mine):
        assert torch.allclose(got, want, rtol=1e-6, atol=1e-7), p


@pytest.mark.parametrize("name", CELLS)
def test_first_steps_match_the_programs_in_float32(name):
    cell = small_cell(name, dtype="float32")
    seed = 2**31 + 11
    tokens = generate.corpus(cell.traffic, cell.config["vocab_size"], seed,
                             generate.steps_for(cell.traffic, 0))
    prog = train.Program(cell, seed, torch.device("cpu"), tokens)
    try:
        got = prog.first_steps()
    finally:
        prog.close()
    want = train.reference_readings(cell, seed, torch.device("cpu"), tokens)
    gaps = check.gaps(got, want)
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4 and gaps["change_gap"] < 1e-4, gaps


def test_mamba2_leaves_are_made_as_mamba2_initialises_them():
    spec = {"dt_bias": Leaf((4096,), "dt_bias", dtype="float32"),
            "A_log": Leaf((4096,), "a_log", dtype="float32"), "bias": Leaf((3,), "zeros")}
    init = {"time_step_min": 1e-3, "time_step_max": 0.1, "time_step_floor": 1e-4,
            "A_init_range": [1, 16]}
    w = weights.make(spec, 7, torch.device("cpu"), "bfloat16", init)
    dt = torch.nn.functional.softplus(w["dt_bias"])
    assert w["dt_bias"].dtype == torch.float32 and w["bias"].dtype == torch.bfloat16
    assert 1e-3 * (1 - 1e-4) <= float(dt.min()) and float(dt.max()) <= 0.1 * (1 + 1e-4)
    assert float(dt.log().std()) == pytest.approx((np.log(100) ** 2 / 12) ** 0.5, rel=0.05)
    a = w["A_log"].exp()
    assert 1 - 1e-4 <= float(a.min()) and float(a.max()) <= 16 * (1 + 1e-4)
    assert not w["bias"].any()
    again = weights.make(spec, 7, torch.device("cpu"), "bfloat16", init)
    assert all(torch.equal(w[k], again[k]) for k in w)
