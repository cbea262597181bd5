"""The check that decides ``correct``, shown to fail: at a small size on the
CPU, a whole run with the timed path broken underneath (a step that returns
its state unchanged; half of each batch left out, the mean over the rest)
and the control (the reference on fp8 products in the program's place) come
out not correct under limits set at that size (``small.LIMITS``), and a
sound run comes out correct. The readings at the cells' own sizes, on the
chip, and the limits set from them are in PERF.md."""

import time

import pytest
import torch

from portbench.kinds import train
from portbench import check, generate

from small import small_cell

CELLS = ("phi4-train-s2048",)
SEED = 2**31 + 29


def run(cell, fault=None):
    return train.run(cell, SEED, 0.2, False, torch.device("cpu"), time.perf_counter(),
                       fault=fault)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    result = run(small_cell(name))
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_step_is_not_correct(name, fault):
    result = run(small_cell(name), fault=fault)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = small_cell(name)
    tokens = generate.corpus(cell.traffic, cell.config["vocab_size"], SEED,
                             generate.steps_for(cell.traffic, 0))
    cpu = torch.device("cpu")
    control = train.reference_readings(cell, SEED, cpu, tokens, precision="fp8")
    want = train.reference_readings(cell, SEED, cpu, tokens)
    correct, checks = check.judge(check.gaps(control, want), cell.limits)
    assert not correct, checks
