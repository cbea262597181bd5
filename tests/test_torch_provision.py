"""The port's copies of ``repro``'s pure-Python layers: each copied module byte
for byte (``obs/__init__.py`` by its code and names, its docstring the
port's; ``data/pipeline.py`` once the lines of its spans are taken out),
every module of the campaign layers copied, and the provisioning layer
(``provision/``, ``pool/``) behaving as ``repro``'s on the same calls:
sessions of every lifetime class and backend, a negotiation that fails with
every backend's reason, a pool lease's hits, misses and LRU eviction, a
mirrored session that loses a storage node and still reads, and the modeled
deploy and staging seconds, equal exactly. Each scenario runs once on each
package and returns plain data."""

import ast
import importlib
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
GB, TB = 1e9, 1e12

# copies of repro's modules; core/perfmodel.py (the H100 profile) and
# core/__init__.py (its export) carry the port's additions; obs/__init__.py's
# docstring names the port (test_obs_init_is_repros_code)
NOT_COPIED = ("core/perfmodel.py", "core/__init__.py", "obs/__init__.py")
COPIED = sorted(
    str(p.relative_to(ROOT / "src" / "repro"))
    for d in ("core", "data", "provision", "pool", "chaos", "obs", "pilot", "orchestrator",
              "serving")
    for p in (ROOT / "src" / "repro" / d).glob("*.py")
    if str(p.relative_to(ROOT / "src" / "repro")) not in NOT_COPIED
) + ["runtime/fault.py"]
# whole lines the port adds to a copied module (the loader's span and the
# bytes it counts, repro_torch/spans.py), each there once
SPAN_LINES = {"data/pipeline.py": ("from ..spans import spanned, tally",
                                   '@spanned("data.batch_at")',
                                   "tally(read_bytes=len(raw))")}


@pytest.mark.parametrize("rel", COPIED)
def test_copy_is_byte_identical(rel):
    port = (ROOT / "src" / "repro_torch" / rel).read_bytes().splitlines(keepends=True)
    added = SPAN_LINES.get(rel, ())
    kept = [line for line in port if line.decode().strip() not in added]
    assert len(port) - len(kept) == len(added), rel
    assert b"".join(kept) == (ROOT / "src" / "repro" / rel).read_bytes(), rel


def test_copies_cover_provision_and_pool():
    assert {"provision/service.py", "provision/backends.py", "pool/manager.py",
            "pool/eviction.py", "provision/__init__.py", "pool/__init__.py"} <= set(COPIED)


@pytest.mark.parametrize("layer,n", [("chaos", 4), ("obs", 9), ("pilot", 4),
                                     ("orchestrator", 7), ("serving", 6)])
def test_copies_cover_campaign_layers(layer, n):
    """Every module of each campaign layer is copied and listed, the
    layer's ``__init__.py`` included; obs/__init__.py alone is held by its
    code."""
    files = {str(p.relative_to(ROOT / "src" / "repro"))
             for p in (ROOT / "src" / "repro" / layer).glob("*.py")}
    assert len(files) == n
    assert files - {"obs/__init__.py"} <= set(COPIED)
    port = {str(p.relative_to(ROOT / "src" / "repro_torch"))
            for p in (ROOT / "src" / "repro_torch" / layer).glob("*.py")}
    assert port == files


def _code_and_names(path):
    tree = ast.parse(path.read_text())
    body = tree.body
    if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
        body = body[1:]
    names, all_ = set(), None
    for node in body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__"
                                                  for t in node.targets):
            all_ = ast.literal_eval(node.value)
    return ast.dump(ast.Module(body=body, type_ignores=[])), names, all_


def test_obs_init_is_repros_code():
    """The port's obs/__init__.py: repro's code, with a docstring of its own
    (a byte copy's indented ``from repro.obs ...`` lines would fail the
    import guard)."""
    port = ROOT / "src" / "repro_torch" / "obs" / "__init__.py"
    ref = ROOT / "src" / "repro" / "obs" / "__init__.py"
    code, names, all_ = _code_and_names(port)
    ref_code, ref_names, ref_all = _code_and_names(ref)
    assert code == ref_code
    assert (names, all_) == (ref_names, ref_all) and set(all_) <= names
    assert ast.get_docstring(ast.parse(port.read_text())) != ast.get_docstring(
        ast.parse(ref.read_text()))
    import repro.obs
    import repro_torch.obs
    assert repro_torch.obs.__all__ == repro.obs.__all__
    assert all(hasattr(repro_torch.obs, n) for n in repro_torch.obs.__all__)


def _pkg(name: str):
    return (importlib.import_module(f"{name}.core"), importlib.import_module(f"{name}.provision"),
            importlib.import_module(f"{name}.pool"))


def lifetimes(name, tmp):
    """A session of each lifetime class and backend: what it was granted and
    costs, and the scheduler's free (compute, storage) counts open and after."""
    core, P, pool = _pkg(name)
    svc = P.ProvisioningService(core.dom_cluster())
    svc.ensure_pools()
    d = pool.DatasetRef("shared", 20 * GB)
    specs = [
        P.StorageSpec("eph", nodes=1, managers=("ephemeralfs",)),
        P.StorageSpec("pool", nodes=1, lifetime=P.LifetimeClass.PERSISTENT),
        P.StorageSpec("lease", lifetime=P.LifetimeClass.POOLED, datasets=(d,),
                      stage_in_bytes=1 * GB),
        P.StorageSpec("g", managers=("globalfs",), datasets=(pool.DatasetRef("g", 30 * GB),),
                      stage_in_bytes=2 * GB),
        P.StorageSpec("kv", nodes=1, access="kv"),
        P.StorageSpec("dry", nodes=1, managers=("null",)),
    ]
    out = []
    sessions = []
    for spec in specs:
        s = svc.open_session(spec, n_compute=1)
        sessions.append(s)
        out.append({"backend": s.backend, "lifetime": s.lifetime.value,
                    "nodes": len(s.storage_nodes), "provision_s": s.provision_time_s,
                    "stage_in_bytes": s.stage_in_bytes, "saved_bytes": s.saved_bytes,
                    "stage_in_s": s.stage_in_time_s, "free": svc.scheduler.free_counts()})
    kv = svc.open_session(P.StorageSpec("kvm", nodes=1, access="kv", managers=("kvstore",)),
                          materialize=True, base_dir=str(tmp / name / "kv"))
    store = kv.mount()
    store.put(b"k", b"v")
    out.append({"kv": store.get(b"k")})
    kv.release()
    for s in reversed(sessions):
        s.release()
        out.append({"released": s.released, "free": svc.scheduler.free_counts()})
    out.append({"opened": dict(svc.stats.sessions_opened),
                "released": svc.stats.sessions_released})
    return out


def negotiation_error(name, tmp):
    """100 TB at a 1 PB/s floor across every registered backend and an
    unregistered one: the error names each with its reason."""
    core, P, _ = _pkg(name)
    svc = P.ProvisioningService(core.dom_cluster())
    spec = P.StorageSpec("hopeless", capacity_bytes=100 * TB, qos=P.QoS(min_bandwidth=1e15),
                         managers=("ephemeralfs", "globalfs", "kvstore", "hdf5-cloud"))
    with pytest.raises(P.NegotiationError) as ei:
        svc.negotiate(spec)
    err = ei.value
    return {"spec": err.spec_name, "message": str(err),
            "reasons": {r.backend: r.reason for r in err.rejections}}


def pool_lease(name, tmp):
    """Leases on a 100 GB pool: a miss, a hit, then pressure that evicts the
    least recently used dataset, which the next lease stages again."""
    core, _, pool = _pkg(name)
    mgr = pool.PoolManager(core.Scheduler(core.dom_cluster()))
    p = mgr.create_pool(nodes=1, cap_bytes=100 * GB)
    old, other = pool.DatasetRef("old", 40 * GB), pool.DatasetRef("other", 30 * GB)
    out = []
    l1 = mgr.try_acquire("a", [old], now=0.0)
    mgr.on_stage_in_complete(l1, 1.0)
    l2 = mgr.try_acquire("b", [old, other], now=2.0)
    mgr.on_stage_in_complete(l2, 2.5)
    mgr.release(l1, 3.0)
    mgr.release(l2, 4.0)
    l3 = mgr.try_acquire("c", [pool.DatasetRef("new", 50 * GB)], now=5.0)
    mgr.on_stage_in_complete(l3, 6.0)
    mgr.release(l3, 7.0)
    l4 = mgr.try_acquire("d", [old], now=8.0)
    for lease in (l1, l2, l3, l4):
        out.append({"hits": lease.hits, "misses": lease.misses,
                    "resident": lease.resident_bytes,
                    "missing": sorted(x.name for x in lease.missing)})
    mgr.check_invariants()
    out.append({"evictions": mgr.evictor.evictions, "used": p.used_bytes,
                "hits": mgr.stats.dataset_hits, "misses": mgr.stats.dataset_misses,
                "saved": mgr.stats.bytes_saved,
                "resident": {n: mgr.catalog.resident(p.pool_id, n)
                             for n in ("old", "other", "new")}})
    return out


def mirrored(name, tmp):
    """A mirrored two-node session: write, kill a storage node, read back."""
    core, P, _ = _pkg(name)
    svc = P.ProvisioningService(core.dom_cluster())
    sess = svc.open_session(P.StorageSpec("m", nodes=2, managers=("ephemeralfs",),
                                          placement=P.Placement(mirror=True)),
                            n_compute=2, materialize=True, base_dir=str(tmp / name / "efs"))
    payload = bytes(range(256)) * 40_000
    c = sess.mount("rank0")
    c.makedirs("/ckpt")
    c.write_file("/ckpt/a.bin", payload)
    fs = sess.deployment.fs
    before = fs.degraded()
    victim = sess.storage_nodes[1].node_id
    fs.kill_node(victim)
    back = c.read_file("/ckpt/a.bin")
    out = {"victim": victim, "degraded": [before, fs.degraded()], "equal": back == payload,
           "can_degrade": sess.can_degrade, "write_s": sess.checkpoint_write_s(len(payload))}
    sess.release()
    out["free"] = svc.scheduler.free_counts()
    return out


def modeled(name, tmp):
    """Modeled seconds: deploys of 1-4 nodes, stage in and out and a
    checkpoint burst at a few sizes, healthy and degraded."""
    core, P, _ = _pkg(name)
    svc = P.ProvisioningService(core.dom_cluster())
    out = {"deploy": [core.perfmodel.predict_deploy_time(n) for n in (1, 2, 4)]}
    for mirror in (False, True):
        s = svc.open_session(P.StorageSpec(f"s{mirror}", nodes=2, managers=("ephemeralfs",),
                                           placement=P.Placement(mirror=mirror)))
        row = {"provision": s.provision_time_s}
        for nbytes in (1e6, 1e9, 8.6e8, 1e12):
            row[nbytes] = (s.stage_time_s(nbytes, "in"), s.stage_time_s(nbytes, "out"),
                           s.checkpoint_write_s(nbytes))
        if s.can_degrade:
            s.degrade()
            row["degraded"] = (s.stage_time_s(1e9, "in"), s.checkpoint_write_s(1e9))
        out[mirror] = row
        s.release()
    return out


SCENARIOS = {f.__name__: f for f in (lifetimes, negotiation_error, pool_lease, mirrored,
                                     modeled)}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_provisioning_behaves_as_repro(scenario, tmp_path):
    run = SCENARIOS[scenario]
    assert run("repro_torch", tmp_path) == run("repro", tmp_path)


def test_scenarios_see_what_they_are_for(tmp_path):
    """The scenarios are not vacuous: every backend and lifetime opened,
    every reason given, a hit, a miss and an eviction, a degraded read."""
    got = lifetimes("repro_torch", tmp_path)
    assert {r["backend"] for r in got if "backend" in r} == {
        "ephemeralfs", "globalfs", "kvstore", "null"}
    assert {r["lifetime"] for r in got if "lifetime" in r} == {
        x.value for x in importlib.import_module("repro_torch.provision").LifetimeClass}
    reasons = negotiation_error("repro_torch", tmp_path)["reasons"]
    assert set(reasons) == {"ephemeralfs", "globalfs", "kvstore", "hdf5-cloud"}
    assert all(reasons.values())
    lease = pool_lease("repro_torch", tmp_path)
    assert lease[1]["hits"] == 1 and lease[3]["misses"] == 1 and lease[4]["evictions"] >= 1
    m = mirrored("repro_torch", tmp_path)
    assert m["degraded"] == [False, True] and m["equal"]
