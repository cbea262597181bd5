"""The training kind: a closed loop of the program's training step over the
provisioned burst tier. Set-up builds one ``TrainState`` from the weights
the benchmark made and drives it through its first steps (the check's
readings, and the warm-up of every shape); the window measures; the
reference follows the first steps after the window. From the program it
takes the training step (``runtime.make_train_step`` over ``optim.init``'s
state), the provisioning and staging (``core``, ``data``) and the
loader."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .. import check, generate, trace
from .. import weights as weights_mod
from ..harness import Cell, Storage, free_device, load_reader, model_config
from ..reference import train as reference_train
from ..reference.layout import flatten, unflatten


class Program:
    """The system under test, built once: the weights the benchmark made, the
    optimizer's state, the training step, and the feed from the loader over
    the staged corpus. ``fault`` plants a fault for the checks' own tests:
    "unchanged" (a step that returns its state as it was) or "half_batch"
    (half of each batch left out, the mean over the rest)."""

    def __init__(self, cell: Cell, seed: int, device: torch.device, tokens: np.ndarray,
                 fault: str | None = None):
        from repro_torch.data import DatasetSpec, Loader
        from repro_torch.models import build_model
        from repro_torch.optim import AdamWConfig
        from repro_torch.optim import init as opt_init
        from repro_torch.runtime import RuntimeConfig, TrainState, make_train_step
        self.cell, self.seed, self.device, self.fault = cell, seed, device, fault
        cfg, tr = cell.config, cell.traffic
        self.storage = Storage(tokens, tr["shard_tokens"])
        try:
            spec = DatasetSpec(seed=seed, vocab=cfg["vocab_size"], n_tokens=tokens.size,
                               shard_tokens=tr["shard_tokens"])
            self.loader = Loader(spec, batch=tr["batch"], seq=tr["seq"],
                                 fs=self.storage.deployment.fs, root="/data")
            self.capacity = tokens.size // (tr["batch"] * (tr["seq"] + 1))
            self.model = build_model(model_config(cfg))
            rt = RuntimeConfig(remat=cfg["train"]["remat"], schedule=cfg["train"]["schedule"],
                               opt=AdamWConfig(**cell.optimizer))
            params = unflatten(sorted(self.make_weights().items()))
            self.state = TrainState(params, opt_init(params), ())
            self.step_fn = make_train_step(self.model, rt)
        except BaseException:
            self.storage.close()
            raise
        self.host_spans: list = []         # (what, start_ns, end_ns)
        self.loader_s: list = []
        self.first_copy_ns = None

    def make_weights(self) -> dict:
        cfg = self.cell.config
        return weights_mod.make(self.cell.family.param_spec(cfg), self.seed, self.device,
                                cfg["dtype"], cfg.get("init"))

    def feed(self, step: int) -> dict:
        """Batch ``step`` from the loader, on the device: pinned host memory,
        copied without a synchronise."""
        if step >= self.capacity:
            raise RuntimeError(f"the corpus holds {self.capacity} batches; "
                               f"step {step} reads past it")
        t0 = time.perf_counter_ns()
        raw = self.loader.batch_at(step)
        out = {}
        for k in ("tokens", "labels"):
            t = torch.from_numpy(raw[k].astype(np.int64))
            if self.fault == "half_batch":
                t = t[: t.shape[0] // 2]
            if self.device.type == "cuda":
                if self.first_copy_ns is None:
                    self.first_copy_ns = time.perf_counter_ns()
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        t1 = time.perf_counter_ns()
        self.host_spans.append(("loader (batch_at and the copy to the device)", t0, t1))
        self.loader_s.append((t1 - t0) / 1e9)
        return out

    def step(self, i: int) -> torch.Tensor:
        batch = self.feed(i)
        t0 = time.perf_counter_ns()
        if self.fault == "unchanged":
            with torch.no_grad():
                loss = self.model.loss(self.state.params, batch)[0]
        else:
            self.state, metrics = self.step_fn(self.state, batch)
            loss = metrics["loss"]
        self.host_spans.append(("train step (launching its work)", t0, time.perf_counter_ns()))
        return loss.detach()

    def first_steps(self) -> dict:
        """The check's readings of the first steps, which also warm up every
        shape the window runs: each step's loss, each leaf's first gradient as
        the optimizer took it (its first moment over 1 - b1) and each leaf's
        change from the initial weights, which are made again from the seed."""
        b1 = self.cell.optimizer["b1"]
        losses, grad = [], {}
        for i in range(self.cell.traffic["check_steps"]):
            losses.append(self.step(i))
            if i == 0:
                grad = {p: t.norm() / (1 - b1) for p, t in flatten(self.state.opt.m)}
        init = self.make_weights()
        change = {p: (t - init[p].float()).norm() for p, t in flatten(self.state.opt.master)}
        del init
        return {"loss": [float(x) for x in losses], "grad": {p: float(v) for p, v in grad.items()},
                "change": {p: float(v) for p, v in change.items()}}

    def close(self):
        self.storage.close()
        self.state = self.step_fn = None


def reference_readings(cell: Cell, seed: int, device, tokens: np.ndarray,
                       precision: str = "float32") -> dict:
    """The reference's readings of the same first steps: weights made again
    from the seed, batches cut from the same corpus."""
    cfg, tr = cell.config, cell.traffic
    spec = cell.family.param_spec(cfg)

    def make_weights():
        return weights_mod.make(spec, seed, device, cfg["dtype"], cfg.get("init"))
    batches = []
    for k in range(tr["check_steps"]):
        t, lab = generate.batch(tokens, tr, k)
        batches.append((torch.from_numpy(t.astype(np.int64)).to(device),
                        torch.from_numpy(lab.astype(np.int64)).to(device)))
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return reference_train.first_steps(cell.family, cfg, cell.optimizer, make_weights,
                                           batches, precision=precision)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def run(cell: Cell, seed: int, seconds: float, traced: bool, device: torch.device,
        started: float, fault: str | None = None) -> dict:
    """One run of ``cell``: the result's fields, and the checks under
    "checks". ``started``: the host clock when the process began; ``fault``
    as ``Program`` takes it, for the checks' own tests."""
    tr = cell.traffic
    tokens = generate.corpus(tr, cell.config["vocab_size"], seed, generate.steps_for(tr, seconds))
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    phases = {"imports_and_corpus": time.perf_counter() - started}
    prog = Program(cell, seed, device, tokens, fault=fault)
    try:
        sync()
        phases["storage_weights_state"] = time.perf_counter() - started - sum(phases.values())
        readings = prog.first_steps()
        sync()
        setup_s = time.perf_counter() - started
        phases["first_steps"] = setup_s - sum(phases.values())
        prog.host_spans.clear()
        prog.loader_s.clear()
        prog.first_copy_ns = None
        modules = trace.kernel_modules() if traced else {}
        taps = trace.Taps(modules)
        with contextlib.ExitStack() as tracing:
            if traced:
                from torch.profiler import ProfilerActivity, profile
                tracing.enter_context(taps)
                prof = tracing.enter_context(profile(activities=[ProfilerActivity.CUDA]))
            losses, i = [], tr["check_steps"]
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                losses.append(prog.step(i))
                i += 1
            sync()
            window_s = time.perf_counter() - t0
        steps = len(losses)
        failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        if traced:
            window = trace.Window(
                steps=steps, window_s=window_s,
                model_flops_per_step=cell.family.model_flops(cell.config, tr["batch"], tr["seq"]),
                loader_s=list(prog.loader_s), events=trace.device_events(prof), taps=taps.calls,
                modules=modules, host_spans=list(prog.host_spans),
                first_copy_ns=prog.first_copy_ns)
            del prof
    finally:
        prog.close()
        del prog
        free_device()

    want = reference_readings(cell, seed, device, tokens)
    numbers = check.gaps(readings, want)
    correct, checks = check.judge(numbers, cell.limits)
    correct = correct and failed == 0 and steps > 0

    tokens_per_s = steps * tr["batch"] * tr["seq"] / window_s
    result = {"correct": correct, "attempted": steps, "failed": failed}
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                   "count": 1, "memory_peak_bytes": int(peak)}
    metrics = {}
    if not traced:
        values = {"train_tokens_per_s": tokens_per_s, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        device_info["busy_s"] = window.busy_s
        device_info["window_s"] = window.window_s
        for m in cell.per_layer:
            got = load_reader(m["name"])(window)
            if got is not None:
                metrics[m["name"]] = {"unit": m["unit"], **got}
        result["breakdown"] = window.breakdown()
    result["metrics"] = metrics
    result["device"] = device_info
    result["setup_phases_s"] = phases
    result["checks"] = checks
    return result
