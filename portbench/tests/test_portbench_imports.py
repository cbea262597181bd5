"""What a cell's run loads: a fresh interpreter drives a whole run of each
cell at a small size on the CPU (the harness's import graph, the program's
modules it calls and the reference after the window) and lists its
modules. Neither JAX nor the JAX package may be among them, compared by
top-level name as a whole word (the port's name begins with the JAX
package's); the references and the weight maker load nothing of the port."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

RUN_A_CELL = r"""
import importlib, json, os, sys, time
root = sys.argv[1]
sys.path[:0] = [os.path.join(root, "src"), root, os.path.join(root, "portbench", "tests")]
import torch
from portbench import harness, trace
from small import small_cell
cell = small_cell(sys.argv[2])
kind = importlib.import_module(f"portbench.kinds.{cell.traffic['kind']}")
kind.run(cell, 2**31 + 3, 0.2, False, torch.device("cpu"), time.perf_counter())
trace.kernel_modules()
for m in cell.per_layer:
    harness.load_reader(m["name"])
print(json.dumps(sorted(sys.modules)))
"""

LOAD_REFERENCES = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import portbench.weights, portbench.generate, portbench.check
from portbench.reference import adamw, dense, layout, ops, train
print(json.dumps(sorted(sys.modules)))
"""


def modules_of(code: str, *args) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, ROOT, *args], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("name", ["phi4-train-s2048"])
def test_a_run_loads_neither_jax_nor_the_jax_package(name):
    loaded = {m.split(".")[0] for m in modules_of(RUN_A_CELL, name)}
    assert "repro_torch" in loaded
    assert not loaded & FORBIDDEN, sorted(loaded & FORBIDDEN)


def test_the_references_load_nothing_of_the_port():
    loaded = {m.split(".")[0] for m in modules_of(LOAD_REFERENCES)}
    found = loaded & (FORBIDDEN | {"repro_torch"})
    assert not found, sorted(found)
