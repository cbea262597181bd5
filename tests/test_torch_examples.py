"""The port's examples run to their end on the CPU (``--device cpu``): the
serve example's own checks (output shape, final cache position, as
examples/serve_decode.py:58-59) on the dense and the MoE arch, on gemma3
(its 48-token prompt wraps the 32-slot ring), on internvl2 (a patch
prefix), on xlstm (the recurrent state) and on whisper (zero frames), and the
train example on the train driver's default MoE arch, on gemma3 (48 tokens
across its 32-slot window), on zamba2 (the hybrid), on xlstm and on
whisper, and the elastic-restart example on its default phi4-mini and on
whisper."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("script,args", [
    ("torch_serve_decode.py", []),
    ("torch_serve_decode.py", ["--arch", "qwen3-moe-30b-a3b"]),
    ("torch_serve_decode.py", ["--arch", "gemma3-12b"]),
    ("torch_serve_decode.py", ["--arch", "internvl2-2b"]),
    ("torch_serve_decode.py", ["--arch", "xlstm-1.3b"]),
    ("torch_serve_decode.py", ["--arch", "whisper-tiny"]),
    ("torch_train_lm.py", ["--steps", "6", "--batch", "2", "--seq", "32", "--ckpt-every", "3"]),
    ("torch_train_lm.py", ["--arch", "gemma3-12b", "--steps", "6", "--batch", "2", "--seq", "48",
                           "--ckpt-every", "3"]),
    ("torch_train_lm.py", ["--arch", "zamba2-7b", "--steps", "6", "--batch", "2", "--seq", "48",
                           "--ckpt-every", "3"]),
    ("torch_train_lm.py", ["--arch", "xlstm-1.3b", "--steps", "6", "--batch", "2", "--seq", "48",
                           "--ckpt-every", "3"]),
    ("torch_train_lm.py", ["--arch", "whisper-tiny", "--steps", "6", "--batch", "2", "--seq",
                           "48", "--ckpt-every", "3"]),
    ("torch_elastic_restart.py", []),
    ("torch_elastic_restart.py", ["--arch", "whisper-tiny"]),
])
def test_example_runs_on_cpu(script, args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script), *args,
                          "--device", "cpu"], cwd=ROOT, env=env, text=True,
                         capture_output=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.rstrip().endswith("OK")
