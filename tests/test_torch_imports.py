"""The port imports torch and never jax or anything of repro: every module of
repro_torch, and chip_smoke, imported in a fresh interpreter leave both out
of sys.modules; and no source of the port names them in an import."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(len(names), bad)
"""

FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)"
                       r"|from\s+repro(\.|\s+import\b))", re.M)


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(maxsplit=1)
    assert int(n) >= 20
    assert bad.strip() == "[]"


def test_port_sources_name_no_jax_or_repro_import():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
                 for p in files for m in FORBIDDEN.finditer(p.read_text())]
    assert offenders == []
    assert FORBIDDEN.search("from repro.core import GlobalFS")
    assert FORBIDDEN.search("import repro.models")
    assert FORBIDDEN.search("    import jax.numpy as jnp")
    assert not FORBIDDEN.search("from repro_torch.core import GlobalFS")
    assert not FORBIDDEN.search("from ..core import GlobalFS")
