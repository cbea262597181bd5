"""What every cell shares: its files, found by the names ``BENCHMARK.json``
gives (the configuration under ``configs/``, the traffic mix under
``traffic/``, the limits under ``limits/``), the per-layer metrics'
readers (``metrics/<name>.py``), and the paper's provisioning flow that
stages a cell's data into a job-scoped EphemeralFS. How a cell runs is its
traffic kind's module, ``kinds/<kind>.py``."""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
from pathlib import Path

import numpy as np
import torch


HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def read_json(path) -> dict:
    return json.loads(Path(path).read_text())


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = dataclasses.field(default_factory=list)
    per_layer: list = dataclasses.field(default_factory=list)

    @classmethod
    def load(cls, name: str) -> "Cell":
        spec = read_json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r}; BENCHMARK.json has {sorted(cells)}")
        entry = cells[name]
        cfg = next(c for c in spec["configs"] if c["name"] == entry["config"])

        def here(metrics):
            return [m for m in metrics if name in m.get("workloads", [name])]
        return cls(name=name, chips=entry["chips"], config=read_json(ROOT / cfg["file"]),
                   traffic=read_json(HERE / "traffic" / f"{entry['traffic']}.json"),
                   limits=read_json(HERE / "limits" / f"{name}.json"),
                   end_to_end=here(spec["end_to_end"]), per_layer=here(spec["per_layer"]))

    @property
    def family(self):
        return importlib.import_module(f"{__package__}.reference.{self.config['reference']}")

    @property
    def optimizer(self) -> dict:
        return self.config["train"]["optimizer"]


class Storage:
    """The paper's flow for a training job: a compute and storage allocation,
    an EphemeralFS deployed on the granted storage nodes, the corpus written
    to the global FS and staged in."""

    def __init__(self, tokens: np.ndarray, shard_tokens: int):
        from repro_torch.core import (FSClient, GlobalFS, JobRequest, Provisioner, Scheduler,
                                      StorageRequest, dom_cluster)
        from repro_torch.data import stage_in
        self._undo = []
        try:
            cluster = dom_cluster()
            sched = Scheduler(cluster)
            alloc = sched.submit(JobRequest("portbench-train", n_compute=8,
                                            storage=StorageRequest(nodes=2)))
            self._undo.append(lambda: sched.release(alloc))
            prov = Provisioner(cluster)
            self.deployment = prov.deploy(prov.plan_for(alloc))
            self._undo.append(self.deployment.teardown)
            gfs = GlobalFS()
            self._undo.append(gfs.teardown)
            writer = FSClient(gfs, "corpus-writer")
            writer.makedirs("/datasets/train")
            for i, start in enumerate(range(0, tokens.size, shard_tokens)):
                writer.write_file(f"/datasets/train/shard-{i:05d}.tok",
                                  tokens[start:start + shard_tokens].tobytes())
            stage_in(gfs, self.deployment.fs, "/datasets/train", "/data",
                     src_model=gfs.perf_view(), dst_model=self.deployment.model)
        except BaseException:
            self.close()
            raise

    def close(self):
        while self._undo:
            self._undo.pop()()


def model_config(config: dict):
    from repro_torch.configs.base import ModelConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in config.items() if k in fields})


def free_device():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def load_reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"{__package__}.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
