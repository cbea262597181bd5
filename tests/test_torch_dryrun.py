"""The port's dry-run (``launch/dryrun.py``) on fake worlds, in child
processes (a process group is global to its process), all started at once
by one module fixture.

The counterpart of ``tests/test_distributed.py::test_dryrun_cell_small_mesh_moe``
(the smoke qwen3-moe, accum 2, B 8, S 64, on a (2, 4) mesh), whose JAX side
fails under this container's jax; every family's smoke train, prefill and
decode cells on a (2, 2) mesh; and the command line on the cheapest
production cell (whisper-tiny decode_32k on the 16 x 16 mesh).
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
FAMILIES = ("qwen3-14b", "qwen3-moe-30b-a3b", "gemma3-12b", "internvl2-2b", "zamba2-7b",
            "xlstm-1.3b", "whisper-tiny")
KINDS = ("train", "prefill", "decode")
B, S = 2, 8
TRAIN_VARIANT = "accum=1,remat=none"
# the family cells' child processes, about even in time
GROUPS = {"dense": FAMILIES[:2], "local_global": ("gemma3-12b",),
          "prefix": ("internvl2-2b", "whisper-tiny"), "hybrid": ("zamba2-7b",),
          "ssm": ("xlstm-1.3b",)}

CELLS = textwrap.dedent("""
    import json, sys
    from repro_torch.configs import ShapeSpec, get_smoke
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import init_fake_world, make_smoke_mesh
    (data, model), out, cells = json.loads(sys.argv[1])
    init_fake_world(data * model)
    mesh = make_smoke_mesh(data, model, "cpu")
    recs = [run_cell(get_smoke(arch), ShapeSpec(f"{kind}_{S}", S, B, kind), variant=variant,
                     out_dir=out, mesh=mesh)
            for arch, kind, B, S, variant in cells]
    print(json.dumps(recs))
""")


# a prefill cell run twice: with ``shard_cache`` as it is, then with the build
# it replaced (the whole cache on every rank, then laid out); and what the
# sharded leaves' other ranks' parts weigh
PREFILL_CACHE = textwrap.dedent("""
    import dataclasses, json, math, sys
    from torch.distributed.tensor import Shard
    from repro_torch.configs import ShapeSpec, get_smoke
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import init_fake_world, make_smoke_mesh
    from repro_torch.models import build_model
    from repro_torch.runtime import parallel as par
    from repro_torch.runtime.sharding import cache_shardings, map_with_path
    archs, layers, B, S, out = json.loads(sys.argv[1])
    init_fake_world(4)
    mesh = make_smoke_mesh(2, 2, "cpu")
    shape = ShapeSpec(f"prefill_{S}", S, B, "prefill")
    local = par.shard_cache

    def global_cache(mesh, cache_like, fill):
        cache = build_model(cfg).init_cache(B, S, "cpu")
        return par.distribute_tree(mesh, cache, cache_shardings(mesh, cache))

    res = {}
    for arch in archs:
        cfg = dataclasses.replace(get_smoke(arch), n_layers=layers)
        par.shard_cache = local
        new = run_cell(cfg, shape, out_dir=f"{out}/new", mesh=mesh)
        par.shard_cache = global_cache
        old = run_cell(cfg, shape, out_dir=f"{out}/old", mesh=mesh)
        others = []
        def one(path, t):
            n = math.prod(mesh.size(d) for d, p in enumerate(t.placements)
                          if isinstance(p, Shard))
            others.append(t.numel() * t.element_size() * (1 - 1 / n))
        model = build_model(cfg)
        map_with_path(one, local(mesh, model.init_cache(B, S, "meta"), par.cache_fill(model)))
        res[arch] = {"new": new["memory"], "old": old["memory"], "others": sum(others)}
    print(json.dumps(res))
""")
PREFILL_CACHE_ARCHS = ("qwen3-14b", "gemma3-12b")


def _start(args: list, tmp) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=tmp,
                            env=dict(os.environ, PYTHONPATH=os.path.abspath(REPO_SRC)))


def _cells(mesh, out, cells) -> list:
    return ["-c", CELLS, json.dumps([mesh, str(out), cells])]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    groups = {"moe": ((2, 4), [["qwen3-moe-30b-a3b", "train", 8, 64, "accum=2"]])}
    for name, archs in GROUPS.items():
        groups[name] = ((2, 2), [[a, k, B, S, TRAIN_VARIANT if k == "train" else ""]
                                 for a in archs for k in KINDS])
    procs = {name: _start(_cells(mesh, tmp / name, cells), tmp)
             for name, (mesh, cells) in groups.items()}
    procs["prefill_cache"] = _start(
        ["-c", PREFILL_CACHE, json.dumps([PREFILL_CACHE_ARCHS, 12, 4, 16, str(tmp / "pc")])], tmp)
    procs["cli"] = _start(["-m", "repro_torch.launch.dryrun", "--arch", "whisper-tiny",
                           "--shape", "decode_32k", "--out", str(tmp / "cli")], tmp)
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=240)
            out[name] = {"rc": proc.returncode, "stdout": stdout, "stderr": stderr[-4000:]}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    out["tmp"] = tmp
    return out


def _records(run) -> list:
    assert run["rc"] == 0, run["stderr"]
    return json.loads(run["stdout"].strip().splitlines()[-1])


def test_moe_cell_small_mesh(runs):
    """repro's test_dryrun_cell_small_mesh_moe: flops, collectives (the
    expert-parallel dispatch) and temp memory, and the global flops are the
    one-device step's ``step_costs``, counted here in this process."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_smoke
    from repro_torch.launch.dryrun import runtime_from_variant
    from repro_torch.models import build_model
    from repro_torch.runtime import parallel as par
    from repro_torch.runtime.costs import step_costs

    (rec,) = _records(runs["moe"])
    assert rec["alg_flops_global"] > 0
    assert rec["collectives"]["count"] > 0
    assert rec["memory"]["temp_bytes"] > 0 and rec["memory"]["peak_ok_hbm"]
    assert rec["chips"] == 8 and rec["mesh"] == "2x4"
    model = build_model(get_smoke("qwen3-moe-30b-a3b"))
    rt = runtime_from_variant({"accum": "2"}, "train")
    with FakeTensorMode():
        state = par.make_train_state(model, torch.Generator().manual_seed(0), rt)
        tokens = torch.zeros((8, 64), dtype=torch.long)
    want = step_costs(par.make_train_step(model, rt), state, {"tokens": tokens, "labels": tokens})
    assert rec["alg_flops_global"] == want["flops"]
    assert rec["alg_dot_bytes_global"] == want["dot_bytes"]
    assert rec["terms"]["compute_s"] == pytest.approx(want["flops"] / 8 / 989e12)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_cells_write_records(runs, arch):
    """Train, prefill and decode through ``shard_*`` on a fake (2, 2) world:
    a record file each, with flops, terms and memory; train and prefill
    with collectives."""
    group = next(g for g, archs in GROUPS.items() if arch in archs)
    mine = {r["kind"]: r for r in _records(runs[group]) if r["arch"] == f"{arch}-smoke"}
    assert sorted(mine) == sorted(KINDS)
    for kind, rec in mine.items():
        suffix = "__accum-1_remat-none" if kind == "train" else ""
        path = runs["tmp"] / group / f"{arch}-smoke__{kind}_{S}__2x2{suffix}.json"
        assert json.loads(path.read_text()) == rec
        assert rec["alg_flops_global"] > 0 and rec["chips"] == 4
        assert rec["memory"]["argument_bytes"] > 0 and rec["memory"]["temp_bytes"] > 0
        assert set(rec["terms"]) >= {"compute_s", "memory_s", "collective_s"}
        if kind != "decode":
            assert rec["collectives"]["count"] > 0, rec["collectives"]


@pytest.mark.parametrize("arch", PREFILL_CACHE_ARCHS)
def test_prefill_temp_bytes_hold_only_local_cache_shards(runs, arch):
    """A prefill cell (12 layers, so that the cache outweighs a layer's
    transients; B 4, S 16) on the fake (2, 2) world: ``shard_cache``
    takes at least the sharded leaves' other ranks' parts (global bytes x
    (1 - 1/shards)) off the temp bytes of the build it replaced, which made
    the whole cache on every rank. A fact about this code, not a gate."""
    run = runs["prefill_cache"]
    assert run["rc"] == 0, run["stderr"]
    res = json.loads(run["stdout"].strip().splitlines()[-1])[arch]
    assert res["others"] > 0
    assert res["new"]["argument_bytes"] == res["old"]["argument_bytes"]
    assert res["old"]["temp_bytes"] - res["new"]["temp_bytes"] >= res["others"], res


def test_cli_writes_json(runs):
    run = runs["cli"]
    assert run["rc"] == 0, run["stderr"]
    assert "OK  whisper-tiny" in run["stdout"]
    rec = json.loads((runs["tmp"] / "cli" / "whisper-tiny__decode_32k__16x16.json").read_text())
    assert rec["chips"] == 256 and rec["hw"] == "h100-sxm"
    assert rec["collectives"]["count"] > 0 and rec["memory"]["peak_ok_hbm"] is True
