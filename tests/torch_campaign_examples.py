"""Runs an example of ``examples/`` and its port (``examples/torch_*.py``)
in child interpreters with one ``PYTHONHASHSEED`` (the orchestrator keeps
sets of strings), from copies in a temporary tree so that their artifacts
land in its ``benchmarks/out/``; a helper of the campaign-example tests,
not a test file."""

import hashlib
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# what each example writes under benchmarks/out/; the port's names carry torch_
ARTIFACTS = {
    "quickstart": (), "workflow_campaign": (), "shared_dataset_campaign": (),
    "chaos_campaign": ("chaos_dashboard.html",),
    "pilot_campaign": ("pilot_dashboard.html",),
    "slo_campaign": ("slo_dashboard.html",),
    "trace_campaign": ("trace_campaign.json", "trace_campaign.jsonl"),
    "serving_campaign": ("serving_dashboard.html",),
}
# the host's wall clock, printed beside the simulated seconds
WALL = (re.compile(r"in \d+ ms\)"), re.compile(r"\d+\.\d ms total\)"))


def _run(tree: Path, script: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PYTHONHASHSEED="0",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(tree / "examples" / script)], cwd=tree, env=env,
                         text=True, capture_output=True, timeout=240)
    assert out.returncode == 0, f"{script}: {out.stderr[-4000:]}"
    text = out.stdout
    for pat in WALL:
        text = pat.sub("<wall>", text)
    return text


def _files(out_dir: Path) -> dict:
    return ({p.name: (hashlib.sha256(p.read_bytes()).hexdigest(), p.stat().st_mtime_ns)
             for p in out_dir.iterdir()} if out_dir.exists() else {})


def check_pair(stem: str, tree: Path) -> None:
    """``examples/<stem>.py`` then ``examples/torch_<stem>.py``: both exit 0
    (their own asserts hold), print the same lines once the port's artifact
    names are mapped back and the wall clock is masked, and write the same
    artifacts under their own names, the first's left untouched."""
    (tree / "examples").mkdir()
    for script in (f"{stem}.py", f"torch_{stem}.py"):
        shutil.copy(ROOT / "examples" / script, tree / "examples" / script)
    out_dir = tree / "benchmarks" / "out"
    want = _run(tree, f"{stem}.py")
    theirs = _files(out_dir)
    got = _run(tree, f"torch_{stem}.py")
    for name in ARTIFACTS[stem]:
        got = got.replace(f"torch_{name}", name)
    assert got == want
    names = ARTIFACTS[stem]
    after = _files(out_dir)
    assert set(theirs) == set(names)
    assert set(after) == set(names) | {f"torch_{n}" for n in names}
    assert {n: after[n] for n in names} == theirs
    assert all(after[f"torch_{n}"][0] == theirs[n][0] for n in names)
