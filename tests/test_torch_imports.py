"""The port imports torch and never jax or anything of repro: every module of
repro_torch, chip_smoke and every port example (``examples/torch_*.py``),
imported in a fresh interpreter, leave both out of sys.modules; no source
of the port names them in an import; and the port's hot packages keep off
the cold obs modules, by ``tools/check_obs_imports.py``'s rule."""

import ast
import os
import re
import shutil
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
import ast, importlib.util, pathlib
examples = sorted(pathlib.Path("examples").glob("torch_*.py"))
for path in examples:
    src = path.read_text()
    if 'if __name__ == "__main__":' in src:     # the module, without main()
        spec = importlib.util.spec_from_file_location(f"example_{path.stem}", path)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    else:                                       # a script: its imports only
        body = [n for n in ast.parse(src).body if isinstance(n, (ast.Import, ast.ImportFrom))]
        exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"), {})
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(len(names), len(examples), bad)
"""

EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))

FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)"
                       r"|from\s+repro(\.|\s+import\b))", re.M)


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, n_examples, bad = out.stdout.split(maxsplit=2)
    assert int(n) >= 100
    assert int(n_examples) == len(EXAMPLES) >= 11
    assert bad.strip() == "[]"


def test_port_sources_name_no_jax_or_repro_import():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES
    offenders = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
                 for p in files for m in FORBIDDEN.finditer(p.read_text())]
    assert offenders == []
    assert FORBIDDEN.search("from repro.core import GlobalFS")
    assert FORBIDDEN.search("import repro.models")
    assert FORBIDDEN.search("    import jax.numpy as jnp")
    assert not FORBIDDEN.search("from repro_torch.core import GlobalFS")
    assert not FORBIDDEN.search("from ..core import GlobalFS")


OBS_GUARD = ROOT / "tools" / "check_obs_imports.py"
OBS_LAYERED = ("core", "orchestrator", "pilot", "pool", "provision", "serving", "chaos", "obs")


def _obs_guard(root: Path) -> subprocess.CompletedProcess:
    """``tools/check_obs_imports.py`` over ``root/repro``: the tool's rule
    as it stands, applied to whatever package ``root/repro`` holds."""
    return subprocess.run([sys.executable, str(OBS_GUARD), "--root", str(root)], cwd=ROOT,
                          text=True, capture_output=True, timeout=60)


def test_port_keeps_the_obs_layering(tmp_path):
    """The port seen as ``repro`` (a link), so that the tool's rule, written
    for ``repro``, reads the port's modules: hot packages import only
    ``obs.trace`` at import time, and obs imports nothing of the simulation.
    The port's modules import themselves relatively only, so that nothing
    escapes the rule under another package name."""
    absolute = [f"{p.relative_to(ROOT)}:{n.lineno}"
                for d in OBS_LAYERED for p in sorted((PORT / d).glob("*.py"))
                for n in ast.walk(ast.parse(p.read_text()))
                if isinstance(n, ast.ImportFrom) and n.level == 0
                and (n.module or "").split(".")[0] == "repro_torch"]
    assert absolute == []
    (tmp_path / "repro").symlink_to(PORT, target_is_directory=True)
    out = _obs_guard(tmp_path)
    assert out.returncode == 0, out.stdout
    n_hot = sum(len(list((PORT / d).rglob("*.py"))) for d in OBS_LAYERED[:-1])
    assert f"{n_hot} hot-loop modules clean, 9 obs modules" in out.stdout


def test_obs_layering_finds_a_planted_violation(tmp_path):
    """The same check on a copy of the port with one module-level import of
    a cold obs module in a hot package and one import of the simulation in
    obs: both are found, and only they."""
    for d in OBS_LAYERED:
        shutil.copytree(PORT / d, tmp_path / "repro" / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "repro" / "__init__.py").write_text("")
    (tmp_path / "repro" / "serving" / "planted.py").write_text(
        "from ..obs.metrics import MetricsHub\n")
    (tmp_path / "repro" / "obs" / "planted.py").write_text(
        "from ..orchestrator import engine\n")
    out = _obs_guard(tmp_path)
    assert out.returncode == 1
    found = [line.split(":")[0] for line in out.stdout.splitlines() if ": module-level" in line]
    assert sorted(found) == [os.path.join(tmp_path.name, "repro", "obs", "planted.py"),
                             os.path.join(tmp_path.name, "repro", "serving", "planted.py")]
