"""Fault-tolerance walkthrough on the PyTorch port: heartbeats, straggler
detection, storage-node loss, restart planning, checkpoint restore through
the mirror, resume.

The port's counterpart of ``examples/elastic_restart.py``, a command line
over ``repro_torch.launch.elastic.elastic_restart``, on a reduced config
(phi4-mini-3.8b by default, as the original). Runs on the card unless
``--device cpu`` is given; on the card the reduced config takes head dim
64, the attention kernels' smallest (its own is 32).

Run:  PYTHONPATH=src python examples/torch_elastic_restart.py --device cpu
      PYTHONPATH=src python examples/torch_elastic_restart.py --arch whisper-tiny --device cpu
"""

import argparse
import dataclasses

from repro_torch.configs import get_smoke
from repro_torch.launch.elastic import elastic_restart

ap = argparse.ArgumentParser()
ap.add_argument("--arch", default="phi4-mini-3.8b")
ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
args = ap.parse_args()

cfg = get_smoke(args.arch)
if args.device != "cpu":
    cfg = dataclasses.replace(cfg, head_dim=64)
res = elastic_restart(cfg, device=args.device)
assert res["degraded"] and res["restored_mismatches"] == 0
assert res["restored_step"] == res["plan"]["restore_step"] == res["committed"][-1]
print("OK")
