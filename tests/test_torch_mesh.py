"""The port's mesh layer on gloo worlds on the CPU: the sharded train,
prefill and decode steps of ``runtime/parallel.py`` held to the port's
single-device steps (dense and MoE, and the hybrid, xLSTM, Whisper, gemma3
and VLM families), the MoE layouts to each other, and ``int8_allreduce``
to ``repro``'s.

Each world (``tests/torch_mesh_worlds.py``) is spawned once by a
module-scoped fixture, with its own ``file://`` store and time limit, and
each case below reads its part of the results. The ranks run one thread
each. ``repro`` is run here in the parent (its single-device loss on the
same weights) and in a JAX subprocess (``int8_allreduce`` under
``shard_map`` on 4 host devices), never in a rank.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("torch.distributed")
if not torch.distributed.is_available() or not torch.distributed.is_gloo_available():
    pytest.skip("torch.distributed with gloo is needed", allow_module_level=True)

sys.path.insert(0, os.path.dirname(__file__))
import torch_mesh_worlds as worlds  # noqa: E402

REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _world(name, tmp_path_factory):
    results = worlds.run_world(name, tmp_path_factory.mktemp(f"world_{name}"))
    errors = [r["error"] for r in results if "error" in r]
    assert not errors, errors[0]
    return results


@pytest.fixture(scope="module")
def train_world(tmp_path_factory):
    return _world("train", tmp_path_factory)


@pytest.fixture(scope="module")
def serve_world(tmp_path_factory):
    return _world("serve", tmp_path_factory)


@pytest.fixture(scope="module")
def moe_world(tmp_path_factory):
    return _world("moe", tmp_path_factory)


@pytest.fixture(scope="module")
def families_world(tmp_path_factory):
    return _world("families", tmp_path_factory)


# -- (data 4, model 2), phi4 smoke ---------------------------------------------
def test_every_rank_distributes_identical_params(train_world):
    sums = train_world[0]["checksum"]
    assert len(sums) == 8 and len(set(sums)) == 1
    assert all(r["checksum"] == sums for r in train_world)


@pytest.mark.parametrize("case", ["train", "train_int8"])
def test_sharded_train_step_matches_single_device(train_world, case):
    """accum 2, ZeRO-1, with and without int8 compression: loss within 1e-5
    relative and the params after each step within 1e-5 of max|p|, on every
    rank."""
    for r in train_world:
        res = r[case]
        for a, b in zip(res["losses"], res["ref_losses"], strict=True):
            assert abs(a - b) / abs(b) < 1e-5, (a, b)
        assert max(res["param_err"]) < 1e-5, res["param_err"]
        # ZeRO-1: the optimizer state adds "data" to the param's layout
        assert "Shard(dim=" in res["m_placements"][0]
        assert res["p_placements"][0] == "Replicate()"


def test_sharded_loss_matches_repro(train_world):
    """The sharded step's first loss (the mean over its two microbatches)
    against ``repro``'s single-device loss on the same weights, 1e-4."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_smoke
    from repro.models import build_model as rbuild
    from repro_torch.configs import get_smoke as tsmoke
    from repro_torch.models import build_model as tbuild
    from repro_torch.models.common import tree_map

    tcfg = tsmoke("phi4-mini-3.8b")
    params = tbuild(tcfg).init(torch.Generator().manual_seed(worlds.SEED_PARAMS))
    batch = worlds._batch(tcfg, 8, 32)
    rmodel = rbuild(get_smoke("phi4-mini-3.8b"))
    want = float(rmodel.loss(tree_map(lambda t: jnp.asarray(t.numpy()), params),
                             {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in batch.items()},
                             remat=None)[0])
    got = train_world[0]["train"]["losses"][0]
    assert abs(got - want) < 1e-4, (got, want)


def test_int8_allreduce_matches_repro(train_world, tmp_path):
    """4 ranks (the "data" group): within 1e-6 of max of ``repro``'s
    ``int8_allreduce`` under ``shard_map`` on 4 host devices, within 5% of
    the mean, and nothing but int8 through the collectives."""
    pytest.importorskip("jax")
    xs = np.stack([worlds.int8_input(i).numpy() for i in range(4)])
    np.save(tmp_path / "x.npy", xs)
    code = textwrap.dedent(f"""
        import jax, numpy as np
        from jax.sharding import PartitionSpec as P
        from jax.experimental.shard_map import shard_map
        from repro.optim.compression import int8_allreduce
        mesh = jax.make_mesh((4,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
        x = np.load({str(tmp_path / 'x.npy')!r})
        g = shard_map(lambda xl: int8_allreduce(xl[0], "data")[None], mesh=mesh,
                      in_specs=P("data"), out_specs=P("data"))
        np.save({str(tmp_path / 'y.npy')!r}, np.asarray(g(x)))
    """)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=REPO_SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=180)
    assert out.returncode == 0, out.stderr
    want = np.load(tmp_path / "y.npy")                 # (4, 37, 29), one row a device
    mean = xs.mean(axis=0)
    group = [r["int8_allreduce"] for r in train_world if r["int8_allreduce"]["model_rank"] == 0]
    assert len(group) == 4
    for i, res in enumerate(group):
        y = res["y"]
        assert np.max(np.abs(y - want[i])) <= 1e-6 * np.max(np.abs(want[i]))
        assert np.max(np.abs(y - mean)) <= 0.05 * np.max(np.abs(mean))
        calls = res["calls"]
        assert [c[0] for c in calls] == ["all_to_all_single", "all_gather_into_tensor"]
        assert all(c[1] == c[2] == "torch.int8" for c in calls), calls


# -- (data 2, model 4), qwen3 smoke: KV replicated, cache sequence-sharded ----
def test_sharded_prefill_and_decode_match_single_device(serve_world):
    for r in serve_world:
        res = r["decode"]
        assert max(res["errs"]) < 1e-5, res["errs"]
        assert all(res["tokens_equal"])
        assert res["cache_err"] < 1e-5


def test_sharded_decode_advances_pos(serve_world):
    res = serve_world[0]["decode"]
    assert res["pos"] == [14, 15, 16, 17] and res["ref_pos"] == 17
    # the cache (L, B, S_max, K, hd): batch over "data", sequence over "model"
    assert res["k_placements"] == ["Shard(dim=1)", "Shard(dim=2)"]


# -- (data 2, model 2), qwen3-moe smoke ------------------------------------------
@pytest.mark.parametrize("variant", ["baseline", "moe2d"])
def test_sharded_moe_matches_single_device(moe_world, variant):
    for r in moe_world:
        res = r[variant]
        assert abs(res["loss"] - res["ref_loss"]) / abs(res["ref_loss"]) < 1e-5
        assert res["grad_err"] < 1e-5, res["grad_err"]


def test_moe2d_same_loss_and_grads_as_baseline(moe_world):
    """The bounds of tests/test_variants.py: loss within 1e-6, grads 1e-5."""
    for r in moe_world:
        assert r["variants"]["loss_diff"] <= 1e-6
        assert r["variants"]["grad_abs_diff"] <= 1e-5


def test_dp_decode_replicates_params_and_matches(moe_world):
    for r in moe_world:
        res = r["dp_decode"]
        assert res["replicated"]
        assert max(res["errs"]) < 1e-5, res["errs"]


def test_kernels_refuse_placements_without_an_exact_local_form(moe_world):
    """Nothing gathers silently: flash attention with q's sequence sharded,
    and decode with a window over a sequence-sharded cache, raise and name
    the placements."""
    res = moe_world[0]["refusals"]
    assert res["flash"] is not None and "Shard(dim=1)" in res["flash"], res
    assert res["decode_window"] is not None and "window" in res["decode_window"], res


@pytest.mark.parametrize("kernel", ["flash", "ssd"])
def test_kernels_on_local_shards_match_plain(moe_world, kernel):
    """Forward and backward through ``local_map``: flash attention with the
    KV head picked per rank (q heads over "model", one KV head replicated),
    ssd_intra_chunk with heads over "model"; outputs and grads within 1e-5
    of max."""
    for r in moe_world:
        res = r["local_kernels"][kernel]
        assert res["out"] < 1e-5 and res["grad"] < 1e-5, res


# -- (data 2, model 2), the five families past dense and MoE, and head counts
# that "model" does not divide ---------------------------------------------------
def _family(world, case):
    for r in world:
        assert "error" not in r[case], r[case]["error"]
    return [r[case] for r in world]


@pytest.mark.parametrize("case", worlds.CASES)
def test_sharded_family_trains_like_single_device(families_world, case):
    """Two ZeRO-1 steps through ``shard_train_step``: each loss within 1e-5
    of the one-device step's (relative to the largest), on every rank."""
    for res in _family(families_world, case):
        got, want = res["train"]["losses"], res["train"]["ref_losses"]
        scale = max(abs(x) for x in want)
        assert all(abs(a - b) <= 1e-5 * scale for a, b in zip(got, want, strict=True)), \
            (got, want)


@pytest.mark.parametrize("case", worlds.CASES)
def test_sharded_family_prefill_and_decode_match_single_device(families_world, case):
    """``shard_prefill`` on a laid-out cache, then 3 greedy tokens through
    ``shard_decode_step``: the tokens equal the one-device run's and the
    logits within 1e-5 of max; gemma3's 40-token prompt wraps its 32-slot
    ring (written only by the rank holding each slot)."""
    from repro_torch.configs import get_smoke
    if case == "gemma3-12b":
        assert get_smoke(case).sliding_window < worlds.FAM_S
    for res in _family(families_world, case):
        serve = res["serve"]
        assert all(serve["tokens_equal"]) and len(serve["tokens_equal"]) == worlds.FAM_GEN + 1
        assert max(serve["errs"]) < 1e-5, serve["errs"]
        assert serve["sharded_cache_leaves"] > 0          # the cache is laid out


# -- shard_prefill's cache: each rank makes only its own shards ------------------
def _local_shards_only(storage):
    """Every sharded leaf's local storage is the global bytes over its shard
    count: after the prefill no rank keeps a global leaf's storage. The
    build this replaced passes too (``distribute_tensor`` copies each shard
    on a gloo world); ``tests/test_torch_dryrun.py`` shows that no rank
    makes the global cache on the way."""
    assert storage, "no cache leaf is sharded"
    for path, local, whole, n in storage:
        assert local * n == whole, (path, local, whole, n)


def test_sharded_prefill_cache_is_made_shard_by_shard(serve_world):
    for r in serve_world:
        _local_shards_only(r["decode"]["cache_storage"])


@pytest.mark.parametrize("case", worlds.CASES)
def test_sharded_family_prefill_cache_is_made_shard_by_shard(families_world, case):
    """Every family on (2, 2): the sharded leaves after the prefill hold
    local storage only, and ``shard_cache`` gathers to ``init_cache``'s
    values (gemma3's ``ring_pos`` of -1, the xLSTM's ``m`` of log 0)."""
    for res in _family(families_world, case):
        _local_shards_only(res["serve"]["cache_storage"])
        assert res["serve"]["built_as_init_cache"]


@pytest.mark.parametrize("arch", worlds.FAMILIES + ("qwen3-14b", "qwen3-moe-30b-a3b"))
def test_cache_fill_holds_every_leaf_of_init_cache(arch):
    """``cache_fill``, which ``shard_cache`` fills by, reads each leaf's value
    from a one-row, one-position cache; every leaf of a larger
    ``init_cache`` holds that one value throughout."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model
    from repro_torch.runtime.parallel import cache_fill
    from repro_torch.runtime.sharding import map_with_path

    model = build_model(get_smoke(arch))
    fill = cache_fill(model)

    def one(path, t):
        assert bool((t == fill[path]).all()), (path, fill[path])
    map_with_path(one, model.init_cache(2, 8, "cpu"))
