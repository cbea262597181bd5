"""The port's elastic-restart flow (``repro_torch.launch.elastic``) held to
``repro``'s on the CPU: ``examples/elastic_restart.py``'s steps run through
``repro``'s API (mirrored session, 6 jitted steps with heartbeats,
checkpoints at 3 and 6, a storage node killed, the restart planned, the
checkpoint restored through the degraded mirror, one more step) and through
``elastic_restart`` from the same initial train state
(``make_train_state(model, PRNGKey(0), rt)`` carried across by
``convert.train_state_from_numpy``): every loss and the resumed loss within
1e-4 (as tests/test_models.py:100), the same stragglers, victim, degraded
flag, plan and committed steps. The smoke phi4-mini-3.8b (the example's
arch) and the smoke whisper-tiny (its zero frames reach the step)."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from tests.conftest import JAX_DRIFT_REASON, jax_api_drifted

pytestmark = pytest.mark.skipif(jax_api_drifted(), reason=JAX_DRIFT_REASON)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.core import dom_cluster as jdom_cluster  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.provision import Placement as JPlacement  # noqa: E402
from repro.provision import ProvisioningService as JProvisioningService  # noqa: E402
from repro.provision import StorageSpec as JStorageSpec  # noqa: E402
from repro import runtime as jrt  # noqa: E402
from repro_torch.convert import train_state_from_numpy  # noqa: E402
from repro_torch.launch.elastic import elastic_restart  # noqa: E402
from tests.torch_train_parity import np_tree  # noqa: E402

B, S, STEPS, EVERY = 4, 64, 6, 3
LOSS_TOL = 1e-4


def repro_flow(cfg) -> dict:
    """``examples/elastic_restart.py`` on ``cfg`` through ``repro``'s API,
    with the frames ``repro``'s train driver feeds an encoder-decoder; also
    the initial train state as numpy."""
    svc = JProvisioningService(jdom_cluster())
    session = svc.open_session(
        JStorageSpec("elastic", nodes=2, managers=("ephemeralfs",),
                     placement=JPlacement(mirror=True)),
        n_compute=8, materialize=True)
    alloc, dep = session.allocation, session.deployment
    mgr = JCheckpointManager(dep.fs)
    model = jax_build_model(cfg)
    rt = jrt.RuntimeConfig(remat=None, zero1=False, opt=JAdamWConfig(lr=1e-3))
    state = jrt.make_train_state(model, jax.random.PRNGKey(0), rt)
    initial = np_tree(state)
    step_fn = jax.jit(jrt.make_train_step(model, rt))
    batch = {"tokens": jnp.ones((B, S), jnp.int32), "labels": jnp.ones((B, S), jnp.int32)}
    if cfg.family == "audio":
        batch["frames"] = jnp.zeros((B, cfg.encoder_seq, cfg.d_model), jnp.float32)
    mon = jrt.HeartbeatMonitor([n.node_id for n in alloc.compute_nodes], timeout_s=60)
    losses = []
    for step in range(STEPS):
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        for i, n in enumerate(alloc.compute_nodes):
            mon.beat(n.node_id, step_time_s=4.0 if i == 3 else 1.0)
        if (step + 1) % EVERY == 0:
            mgr.save(step + 1, {"params": state.params, "opt": state.opt})
    victim = session.storage_nodes[1].node_id
    dep.fs.kill_node(victim)
    plan = jrt.plan_restart(alive_chips=240, model_parallel=16, committed_steps=mgr.steps(),
                            dropped_nodes=(victim,))
    restored, rstep = mgr.restore({"params": state.params, "opt": state.opt})
    _, m = step_fn(jrt.TrainState(restored["params"], restored["opt"], ()), batch)
    out = {"initial": initial, "losses": losses, "resumed_loss": float(m["loss"]),
           "stragglers": mon.stragglers(), "victim": victim, "degraded": dep.fs.degraded(),
           "plan": {"mesh_shape": plan.mesh_shape, "mesh_axes": plan.mesh_axes,
                    "restore_step": plan.restore_step},
           "committed": mgr.steps(), "restored_step": rstep}
    session.release()
    return out


@pytest.fixture(scope="module", params=["phi4-mini-3.8b", "whisper-tiny"])
def flows(request):
    cfg = get_smoke(request.param)
    want = repro_flow(cfg)
    lines = []
    got = elastic_restart(cfg, device="cpu", steps=STEPS, ckpt_every=EVERY, batch=B, seq=S,
                          state=train_state_from_numpy(want["initial"]),
                          log=lines.append)
    return cfg, got, want, lines


def test_losses_match_repro(flows):
    cfg, got, want, _ = flows
    assert len(got["losses"]) == len(want["losses"]) == STEPS
    for a, b in zip(got["losses"] + [got["resumed_loss"]],
                    want["losses"] + [want["resumed_loss"]]):
        assert abs(a - b) < LOSS_TOL, (got["losses"], want["losses"])
    assert all(np.isfinite(got["losses"]))


def test_fault_story_matches_repro(flows):
    _, got, want, _ = flows
    for k in ("stragglers", "victim", "degraded", "plan", "committed", "restored_step"):
        assert got[k] == want[k], k
    assert got["stragglers"] == ["nid00003"] and got["degraded"] is True
    assert got["plan"] == {"mesh_shape": (15, 16), "mesh_axes": ("data", "model"),
                           "restore_step": 6}
    assert got["committed"] == [3, 6]


def test_restore_is_bit_exact_and_resumes_like_the_live_state(flows):
    """Every restored leaf (bf16 or float32 params, the float32 master, m, v
    and the step) equals the live state's after the last save; step 7 from
    the restored state and from a clone of the live state give one loss."""
    _, got, _, _ = flows
    assert got["restored_mismatches"] == 0
    assert got["live_loss"] == got["resumed_loss"]


def test_prints_the_examples_lines(flows):
    _, got, want, lines = flows
    assert lines == [
        "straggler detection: ['nid00003']",
        f"killed {want['victim']}; FS degraded=True (mirrored chunks keep serving)",
        "restart plan: mesh (15, 16) axes ('data', 'model'), restore step 6",
        f"resumed from step 6; next loss {got['resumed_loss']:.4f}",
    ]


def test_checkpoint_bytes_and_modeled_times(flows):
    """The step's checkpoint holds every leaf of params and optimizer state
    (npy headers on top); the modeled burst write and stage-out are positive."""
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import leaves
    cfg, got, _, _ = flows
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    raw = sum(t.numel() * (t.element_size() + 3 * 4) for t in leaves(params))
    assert raw < got["ckpt_bytes"] < raw * 1.05
    assert got["modeled_write_s"] > 0 and got["modeled_stage_out_s"] > 0
    assert len(got["save_s"]) == STEPS // EVERY and got["restore_s"] > 0


@pytest.mark.parametrize("steps, every", [(7, 3), (2, 3)])
def test_steps_not_a_multiple_of_ckpt_every_are_refused(steps, every):
    """The restore is checked against the live state, which is the newest
    save only when the last step was saved."""
    from repro_torch.configs import get_smoke as torch_smoke
    with pytest.raises(ValueError, match="multiple of ckpt_every"):
        elastic_restart(torch_smoke("phi4-mini-3.8b"), device="cpu", steps=steps,
                        ckpt_every=every)
