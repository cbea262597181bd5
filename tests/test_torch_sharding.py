"""The port's sharding rules, mesh hints, mesh construction and fault
tolerance (``repro_torch.runtime.sharding``, ``hints``, ``launch.mesh``,
``runtime.fault``), without processes.

The rules are pure shape functions: for every family's smoke and full
config the port's logical specs must equal ``repro``'s PartitionSpec
entries leaf by leaf (params, ZeRO-1 optimizer state, batches, caches) on
shape-only meshes. ``repro``'s side takes its shapes from ``jax.eval_shape``
and an ``AbstractMesh``; the port's from a fake-tensor (meta-backed) init
and a stand-in that has only ``shape`` and ``axis_names``.
"""

import functools
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_config, get_smoke  # noqa: E402
from repro_torch.hints import constrain, flag, hint_spec, mesh_hint  # noqa: E402
from repro_torch.runtime import HeartbeatMonitor, plan_restart  # noqa: E402
from repro_torch.runtime import sharding as sh  # noqa: E402
from repro_torch.runtime.sharding import _sanitize, param_spec  # noqa: E402


class FakeMesh:
    """Shape-only stand-in (the rules read only shape and axis_names)."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESH = FakeMesh({"data": 16, "model": 16})
MESH3 = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4}}


def _norm(spec) -> tuple:
    """PartitionSpec entries (or a logical spec) with singleton tuples as
    their one axis name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


# -- the port's rules, the cases of tests/test_runtime.py --------------------
class TestParamRules:
    def test_ffn_megatron_pattern(self):
        assert param_spec(MESH, "layers/mlp/gate/w", (32, 4096, 16384)) == (None, None, "model")
        assert param_spec(MESH, "layers/mlp/down/w", (32, 16384, 4096)) == (None, "model", None)

    def test_vocab_sharding_with_fallback(self):
        assert param_spec(MESH, "embed/w", (152064, 5120)) == ("model", None)
        assert param_spec(MESH, "embed/w", (92553, 2048)) == (None, None)

    def test_moe_expert_parallel(self):
        assert param_spec(MESH, "layers/moe/gate", (48, 128, 2048, 768)) == \
            (None, "model", None, None)

    def test_stacked_dims_padded(self):
        assert param_spec(MESH, "local_layers/attn/wq/w", (8, 5, 3840, 4096)) == \
            (None, None, None, "model")

    def test_norms_replicated(self):
        assert param_spec(MESH, "layers/ln1/scale", (32, 4096)) == ()

    def test_sanitize_composite_dp_prefix(self):
        assert _sanitize(MESH3, (("pod", "data"), None), (32, 128)) == (("pod", "data"), None)
        assert _norm(_sanitize(MESH3, (("pod", "data"), None), (8, 128))) == ("pod", None)

    def test_sanitize_no_axis_reuse(self):
        assert _sanitize(MESH, ("model", "model"), (32, 32)) == ("model", None)

    def test_zero1_takes_largest_free_dim(self):
        # "model" on dim 0; "data" on the largest free dim that it divides
        assert sh.zero1_spec(MESH, ("model", None), (4096, 1024)) == ("model", "data")
        assert sh.zero1_spec(MESH, (), (8, 1000, 64)) == (None, None, "data")
        assert sh.zero1_spec(MESH, (), (7,)) == (None,)
        # ties go to the first dim, as numpy's argsort orders them
        assert sh.zero1_spec(MESH, (), (64, 64)) == ("data", None)


class TestFault:
    def test_dead_node_detection(self):
        mon = HeartbeatMonitor(["n0", "n1"], timeout_s=10)
        now = time.monotonic()
        mon.beat("n0", now=now + 100)
        assert mon.dead_nodes(now=now + 100) == ["n1"]

    def test_straggler_detection(self):
        mon = HeartbeatMonitor([f"n{i}" for i in range(8)])
        for i in range(8):
            for _ in range(10):
                mon.beat(f"n{i}", step_time_s=1.0 if i else 5.0)
        assert mon.stragglers() == ["n0"]

    def test_no_straggler_when_uniform(self):
        mon = HeartbeatMonitor([f"n{i}" for i in range(4)])
        for i in range(4):
            for t in (1.0, 1.1, 0.9, 1.0, 1.05):
                mon.beat(f"n{i}", step_time_s=t)
        assert mon.stragglers() == []

    def test_restart_plan_shrinks_data_axis(self):
        plan = plan_restart(alive_chips=240, model_parallel=16, committed_steps=[100, 200])
        assert plan.mesh_shape == (15, 16)
        assert plan.restore_step == 200

    def test_restart_plan_multipod(self):
        plan = plan_restart(alive_chips=512, model_parallel=16, committed_steps=[5], pods=2)
        assert plan.mesh_shape == (2, 16, 16)

    def test_restart_plan_too_few_chips(self):
        with pytest.raises(RuntimeError):
            plan_restart(alive_chips=8, model_parallel=16, committed_steps=[])


# -- hints -------------------------------------------------------------------
def test_flag_context():
    assert not flag("moe2d")
    with mesh_hint(None, ("moe2d",)):
        assert flag("moe2d")
        assert not flag("other")
    assert not flag("moe2d")


def test_constrain_without_a_mesh_returns_its_input():
    x = torch.randn(4, 8, 2, 16)
    assert constrain(x, "dp", None, "model", None) is x
    with mesh_hint(None, ("moe2d",)):
        assert constrain(x, "dp", None, "model", None) is x


def test_constrain_leaves_a_plain_tensor_under_a_hint():
    x = torch.randn(4, 8, 2, 16)
    with mesh_hint(MESH):
        assert constrain(x, "dp", None, "model", None) is x


def test_hint_spec_largest_dividing_prefix():
    # 4 heads over "model" 16: not divisible -> replicated; batch 32 over (pod, data)
    assert hint_spec(MESH3, (32, 8, 4, 64), ("dp", None, "model", None)) == \
        (("pod", "data"), None, None, None)
    assert hint_spec(MESH3, (8, 8, 32, 64), ("dp", None, "model", None)) == \
        ("pod", None, "model", None)
    assert hint_spec(FakeMesh({"model": 4}), (8, 3), ("dp", "model")) == (None, None)


def test_runtime_flags_reach_the_config():
    from repro_torch.runtime import RuntimeConfig
    rt = RuntimeConfig(flags=("moe2d",))
    assert "moe2d" in rt.flags and rt.zero1


# -- logical spec -> placements ----------------------------------------------
class _Mesh(FakeMesh):
    """A stand-in with a DeviceMesh's ``mesh_dim_names``."""

    def __init__(self, shape):
        super().__init__(shape)
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(shape.values())


def test_placements_of_logical_specs():
    from torch.distributed.tensor import Replicate, Shard
    m3 = _Mesh({"pod": 2, "data": 16, "model": 16})
    assert sh.placements(m3, (("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert sh.placements(m3, ()) == (Replicate(),) * 3
    assert sh.placements(m3, ("data", "model")) == (Replicate(), Shard(0), Shard(1))
    m2 = _Mesh({"data": 2, "model": 4})
    assert sh.placements(m2, (None, "model", None)) == (Replicate(), Shard(1))


def test_production_mesh_raises_on_a_small_world():
    from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        make_smoke_mesh(2, 2, "cpu")


# -- the rules held to repro's, leaf by leaf ----------------------------------
jax = pytest.importorskip("jax")


@functools.lru_cache(maxsize=None)
def _repro_shapes(arch: str, full: bool):
    from repro.configs import get_config as rget, get_smoke as rsmoke
    from repro.models import build_model as rbuild
    from repro import optim as roptim
    cfg = (rget if full else rsmoke)(arch)
    model = rbuild(cfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    opt = jax.eval_shape(roptim.init, params)
    B, S = _cache_dims(full)
    cache = jax.eval_shape(lambda: model.init_cache(B, S))
    return params, opt, cache


def _cache_dims(full: bool) -> tuple[int, int]:
    return (32, 256) if full else (4, 64)


@functools.lru_cache(maxsize=None)
def _port_shapes(arch: str, full: bool):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import build_model
    cfg = (get_config if full else get_smoke)(arch)
    model = build_model(cfg)
    B, S = _cache_dims(full)
    with FakeTensorMode():
        params = model.init(torch.Generator())
        cache = model.init_cache(B, S, "cpu")
    return params, cache


def _repro_specs(tree) -> dict:
    from repro.runtime.sharding import _path_str
    out = {}
    jax.tree_util.tree_map_with_path(
        lambda p, s: out.__setitem__(_path_str(p), _norm(s.spec)), tree)
    return out


def _abstract(mesh_shape: dict):
    from jax.sharding import AbstractMesh
    return AbstractMesh(tuple(mesh_shape.values()), tuple(mesh_shape))


def _spec_tree_leaves(tree, like) -> dict:
    """{path: spec} of a port spec tree shaped like ``like``."""
    out = {}

    def walk(specs, node, path=""):
        if isinstance(node, dict):
            for k in node:
                walk(specs[k], node[k], f"{path}/{k}" if path else k)
        elif isinstance(node, (tuple, list)) and not hasattr(node, "shape"):
            for i, v in enumerate(node):
                walk(specs[i], v, f"{path}/{i}" if path else str(i))
        else:
            out[path] = _norm(specs)
    walk(tree, like)
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_specs_match_repro(arch, full, mesh_name):
    from repro.runtime import sharding as rsh
    r_params, r_opt, _ = _repro_shapes(arch, full)
    p_params, _ = _port_shapes(arch, full)
    am, fm = _abstract(MESHES[mesh_name]), FakeMesh(MESHES[mesh_name])

    r_ps = rsh.param_shardings(am, r_params)
    p_ps = sh.param_shardings(fm, p_params)
    want, got = _repro_specs(r_ps), _spec_tree_leaves(p_ps, p_params)
    assert got == want

    from repro_torch.optim.adamw import OptState
    r_os = rsh.opt_shardings(am, r_opt, r_ps, zero1=True)
    p_os = sh.opt_shardings(fm, OptState(None, p_params, p_params, p_params), p_ps, zero1=True)
    for part in ("master", "m", "v"):
        want = _repro_specs(getattr(r_os, part))
        assert _spec_tree_leaves(getattr(p_os, part), p_params) == want, part
    assert _norm(r_os.step.spec) == p_os.step == ()
    # ZeRO-1 puts "data" somewhere on most leaves of a full model
    if full:
        specs = _spec_tree_leaves(p_os.m, p_params)
        assert sum("data" in str(s) for s in specs.values()) >= len(specs) // 2


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_repro(arch, full, mesh_name):
    from repro.runtime import sharding as rsh
    from repro.configs import get_config as rget, get_smoke as rsmoke
    _, _, r_cache = _repro_shapes(arch, full)
    _, p_cache = _port_shapes(arch, full)
    am, fm = _abstract(MESHES[mesh_name]), FakeMesh(MESHES[mesh_name])
    cfg = (rget if full else rsmoke)(arch)
    want = _repro_specs(rsh.cache_shardings(am, r_cache, cfg))
    got = _spec_tree_leaves(sh.cache_shardings(fm, p_cache), p_cache)
    assert got == want
    shapes_r = {}
    jax.tree_util.tree_map_with_path(
        lambda p, leaf: shapes_r.__setitem__(rsh._path_str(p), tuple(leaf.shape)), r_cache)
    shapes_p = {}
    sh.map_with_path(lambda p, leaf: shapes_p.__setitem__(p, tuple(leaf.shape)), p_cache)
    assert shapes_p == shapes_r


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("B", [1, 2, 8, 24, 32, 512])
def test_batch_specs_match_repro(B, mesh_name):
    from repro.runtime import sharding as rsh
    am, fm = _abstract(MESHES[mesh_name]), FakeMesh(MESHES[mesh_name])
    batch = {"tokens": np.zeros((B, 128), np.int32), "labels": np.zeros((B, 128), np.int32),
             "patch_embeds": np.zeros((B, 16, 64), np.float32), "token": np.zeros((B,), np.int32)}
    want = _repro_specs(rsh.batch_shardings(am, batch))
    got = _spec_tree_leaves(sh.batch_shardings(fm, batch), batch)
    assert got == want
    assert rsh.dp_axes(am) == sh.dp_axes(fm)


def test_replicated_specs():
    from repro_torch.optim.adamw import leaves
    p, _ = _port_shapes("qwen3-14b", False)
    assert all(s == () for s in leaves(sh.replicated(MESH, p)))
