"""Serving example on the PyTorch port: batched prefill + decode with a KV cache.

The port's counterpart of ``examples/serve_decode.py``: a reduced config, 8
concurrent requests, one prefill, then token-by-token batched greedy decode.
Runs on the card (the port's kernels) unless ``--device cpu`` is given; on
the card the reduced config takes head dim 64, the attention kernels'
smallest (its own is 32).

gemma3-12b's reduced config keeps a 32-slot ring on its local layers, so the
48-token prompt wraps it (also at head dim 64); internvl2-2b puts 16 seeded
patch embeddings before each prompt; xlstm-1.3b decodes from its recurrent
state; whisper-tiny encodes 64 zero frames (the serve driver's
``model_inputs``) and attends to them from every decoder layer.

Run:  PYTHONPATH=src python examples/torch_serve_decode.py [--device cpu]
      [--arch qwen3-moe-30b-a3b | gemma3-12b | internvl2-2b | xlstm-1.3b | whisper-tiny]
"""

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_smoke
from repro_torch.device import resolve_device
from repro_torch.launch.serve import model_inputs
from repro_torch.models import build_model

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="qwen3-14b")
ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
args = ap.parse_args()

BATCH, PROMPT, GEN = 8, 48, 16
dev = resolve_device(args.device)
cfg = get_smoke(args.arch)
if dev.type == "cuda":
    cfg = dataclasses.replace(cfg, head_dim=64)        # the attention kernels' smallest
model = build_model(cfg)
params = model.init(torch.Generator(device=dev).manual_seed(0))
prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
batch = {"tokens": prompts, **model_inputs(cfg, BATCH, dev, 2)}
n_prefix = cfg.n_patches if cfg.family == "vlm" else 0
S_max = n_prefix + PROMPT + GEN


def sync():
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


print(f"[{args.arch}] prefill {BATCH} requests x {PROMPT} tokens on {dev.type} ...")
t0 = time.perf_counter()
logits, cache = model.prefill(params, batch, S_max)
sync()
print(f"prefill: {time.perf_counter() - t0:.2f}s")

tok = torch.argmax(logits, dim=-1)
generated = [tok]
t0 = time.perf_counter()
for i in range(GEN - 1):
    logits, cache = model.decode_step(params, cache, {"token": tok})
    tok = torch.argmax(logits, dim=-1)
    generated.append(tok)
sync()
dt = time.perf_counter() - t0
out = torch.stack(generated, dim=1)
print(f"decoded {GEN - 1} steps x {BATCH} seqs in {dt:.2f}s "
      f"({(GEN - 1) * BATCH / dt:.1f} tok/s on {dev.type})")
print("sample continuation (request 0):", out[0].tolist())
assert out.shape == (BATCH, GEN)
assert int(cache["pos"]) == n_prefix + PROMPT + GEN - 1
print("OK")
