"""Training example on the PyTorch port, through dynamically provisioned storage.

The port's counterpart of ``examples/train_lm.py``: runs
``repro_torch.launch.train.train`` (allocate + provision, stage the corpus
in, train with burst-tier checkpoints drained to the global FS) on a reduced
config. The default arch is the train driver's own, the MoE
granite-moe-1b-a400m. Runs on the card unless ``--device cpu`` is given; on
the card the reduced config takes head dim 64, the attention kernels'
smallest (its own is 32).

Run:  PYTHONPATH=src python examples/torch_train_lm.py --device cpu
      PYTHONPATH=src python examples/torch_train_lm.py --arch phi4-mini-3.8b --steps 20
      PYTHONPATH=src python examples/torch_train_lm.py --arch gemma3-12b --seq 48
      PYTHONPATH=src python examples/torch_train_lm.py --arch zamba2-7b
      PYTHONPATH=src python examples/torch_train_lm.py --arch xlstm-1.3b
      PYTHONPATH=src python examples/torch_train_lm.py --arch whisper-tiny
(gemma3's reduced window is 32 slots, so ``--seq 48`` trains across it;
zamba2's and xlstm's reduced chunk is 32, so the default 128 is four chunks;
whisper's batches carry the zero frames the train driver adds.)
"""

import argparse
import dataclasses

from repro_torch.configs import get_smoke
from repro_torch.launch.train import train

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="granite-moe-1b-a400m")
ap.add_argument("--steps", type=int, default=30)
ap.add_argument("--batch", type=int, default=8)
ap.add_argument("--seq", type=int, default=128)
ap.add_argument("--ckpt-every", type=int, default=10)
ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
args = ap.parse_args()

cfg = get_smoke(args.arch)
if args.device != "cpu":
    cfg = dataclasses.replace(cfg, head_dim=64)
result = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
               ckpt_every=args.ckpt_every, device=args.device)
print(f"final: held-batch loss {result['eval_before']:.3f} -> "
      f"{result['eval_after']:.3f}; committed checkpoint steps {result['steps']}")
assert result["improved"] and result["steps"]
print("OK")
