"""The port's cost layer (``runtime/costs.py``) against ``repro``'s.

``step_costs`` (aten ops on fake tensors) against ``repro.runtime.costs.jaxpr_costs``
(the jaxpr of the same step) on every family's smoke train step (remat None
and "full"), prefill and decode, at B 2, S 12 (the hybrid's and the
xLSTM's chunk cut to 8: two chunks, the second padded). Each smoke config
is cut to its family's smallest whole pattern of layers (one layer; one
gemma3 block, hybrid group or xLSTM block; one Whisper encoder and decoder
layer), the same on both sides: the counts are per layer. Flops are equal, and
``dot_bytes`` too on dense, except where the two sides run different ops;
each such difference is pinned below by its op and formula (``_gaps``),
for the shapes given here (``opt_einsum`` picks ``repro``'s contraction
order by size). ``repro``'s side (JAX) is traced in a child process while
this one counts the port's; ``collective_bytes`` runs in another, as a
process group is global to its process.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import parallel as par  # noqa: E402
from repro_torch.runtime.costs import step_costs  # noqa: E402

REPO_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
B = 2
ARCHS = ("qwen3-14b", "qwen3-moe-30b-a3b", "gemma3-12b", "internvl2-2b", "zamba2-7b",
         "xlstm-1.3b", "whisper-tiny")
KINDS = ("train", "train_remat", "prefill", "decode")
LAYERS = {"gemma3-12b": 3, "zamba2-7b": 2, "xlstm-1.3b": 2}


S, CHUNK = 12, 8


def _cut(cfg):
    if cfg.family == "audio":
        return dataclasses.replace(cfg, n_layers=1, encoder_layers=1)
    return dataclasses.replace(cfg, n_layers=LAYERS.get(cfg.name.removesuffix("-smoke"), 1),
                               ssm_chunk=CHUNK)


# -- the rules on single ops --------------------------------------------------------
def test_dot_flops():
    c = step_costs(lambda a, b: a @ b, torch.zeros(64, 32), torch.zeros(32, 16))
    assert c["flops"] == 2 * 64 * 32 * 16
    assert c["dot_bytes"] == 4 * (64 * 32 + 32 * 16 + 64 * 16)


def test_python_loop_counts_every_iteration():
    """``repro`` multiplies a scan body by its length; here every iteration
    of the loop is dispatched and counted."""
    def f(x, ws):
        for w in ws.unbind(0):
            x = x @ w
        return x
    c = step_costs(f, torch.zeros(8, 8), torch.zeros(10, 8, 8))
    assert c["flops"] == 10 * 2 * 8 * 8 * 8


def test_depthwise_conv_counts_two_per_tap_per_output():
    """2·B·L·C·W for the forward, once more for each gradient: ``repro``'s
    ``_conv_flops`` gives the forward a C-th of that (it divides a per-group
    kernel count by the group count)."""
    from repro_torch.models.mamba2 import _causal_conv
    Bq, L, C, W = 2, 9, 6, 4
    x, w, b = torch.zeros(Bq, L, C), torch.zeros(W, C), torch.zeros(C)
    assert step_costs(_causal_conv, x, w, b)["flops"] == 2 * Bq * L * C * W

    def grads(x, w, b):
        x, w, b = (t.requires_grad_() for t in (x, w, b))
        return torch.autograd.grad(_causal_conv(x, w, b).sum(), (x, w))
    assert step_costs(grads, x, w, b)["flops"] == 3 * 2 * Bq * L * C * W


COLLECTIVES = textwrap.dedent("""
    import json, torch, torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from repro_torch.launch.mesh import init_fake_world
    from repro_torch.runtime.costs import collective_bytes
    init_fake_world(2)
    def f(x):
        for _ in range(7):
            dist.all_reduce(x)
        return funcol.all_gather_tensor(x, 0, dist.group.WORLD)
    print(json.dumps(collective_bytes(f, torch.zeros(4))))
""")


@pytest.fixture(scope="module")
def collectives_child():
    """The fake world's child process, started when the module's first test
    runs, so that it works while the others do."""
    proc = subprocess.Popen([sys.executable, "-c", COLLECTIVES], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=REPO_SRC))
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(autouse=True)
def _start_collectives_child(collectives_child):
    return collectives_child


# -- every family against repro ------------------------------------------------------
def _repro_costs(arch: str, kind: str) -> dict:
    """``repro``'s side (JAX), run in the child process of ``both_sides``."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke as repro_smoke
    from repro.models import build_model as repro_build
    from repro.runtime import RuntimeConfig as ReproRuntime
    from repro.runtime import make_train_state as repro_train_state
    from repro.runtime.costs import jaxpr_costs
    from repro.runtime.parallel import make_decode_step as repro_decode
    from repro.runtime.parallel import make_prefill as repro_prefill
    from repro.runtime.parallel import make_train_step as repro_train_step

    cfg = _cut(repro_smoke(arch))
    model = repro_build(cfg)
    sds, i32 = jax.ShapeDtypeStruct, jnp.int32
    extra = {}
    if cfg.family == "vlm" and kind != "decode":
        extra["patch_embeds"] = sds((B, cfg.n_patches, cfg.d_model), jnp.float32)
    if cfg.family == "audio" and kind != "decode":
        extra["frames"] = sds((B, cfg.encoder_seq, cfg.d_model), jnp.float32)
    rng = sds((2,), jnp.uint32)
    if kind.startswith("train"):
        rt = ReproRuntime(remat="full" if kind == "train_remat" else None)
        state = jax.eval_shape(lambda r: repro_train_state(model, r, rt), rng)
        batch = {"tokens": sds((B, S), i32), "labels": sds((B, S), i32), **extra}
        return jaxpr_costs(jax.make_jaxpr(repro_train_step(model, rt))(state, batch))
    params = jax.eval_shape(model.init, rng)
    if kind == "prefill":
        s_max = S + (cfg.n_patches if cfg.family == "vlm" else 0)
        batch = {"tokens": sds((B, S), i32), **extra}
        return jaxpr_costs(jax.make_jaxpr(repro_prefill(model, s_max, ReproRuntime()))(
            params, batch))
    cache = jax.eval_shape(lambda: model.init_cache(B, S))
    return jaxpr_costs(jax.make_jaxpr(repro_decode(model, ReproRuntime()))(
        params, cache, {"token": sds((B,), i32)}))


def _port_costs(arch: str, kind: str) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = _cut(get_smoke(arch))
    model = build_model(cfg)
    with FakeTensorMode():
        extra = {}
        if cfg.family == "vlm" and kind != "decode":
            extra["patch_embeds"] = torch.zeros((B, cfg.n_patches, cfg.d_model))
        if cfg.family == "audio" and kind != "decode":
            extra["frames"] = torch.zeros((B, cfg.encoder_seq, cfg.d_model))
        tokens = torch.zeros((B, S), dtype=torch.long)
        gen = torch.Generator().manual_seed(0)
        if kind.startswith("train"):
            rt = par.RuntimeConfig(remat="full" if kind == "train_remat" else None)
            state = par.make_train_state(model, gen, rt)
            args = (state, {"tokens": tokens, "labels": tokens.clone(), **extra})
            fn = par.make_train_step(model, rt)
        elif kind == "prefill":
            s_max = S + (cfg.n_patches if cfg.family == "vlm" else 0)
            args = (model.init(gen), {"tokens": tokens, **extra})
            fn = par.make_prefill(model, s_max, par.RuntimeConfig())
        else:
            args = (model.init(gen), model.init_cache(B, S, "cpu"),
                    {"token": torch.zeros((B,), dtype=torch.long)})
            fn = par.make_decode_step(model, par.RuntimeConfig())
    return step_costs(fn, *args)


def _conv_gaps(L: int, C: int, W: int, kind: str) -> dict:
    """A depthwise causal conv over C channels, width W, in each of L layers.
    The port: 2·B·S·C·W a forward and as much for each of its two
    gradients. ``repro`` (``src/repro/runtime/costs.py:47-52``): the forward
    2·B·S·C·W // C; the input's gradient, a conv over the W-1 padded rows,
    2·B·(S+W-1)·C·W; the weight's gradient 2·B·S·C·W. Decode runs the conv
    as an einsum on both sides."""
    conv, repro_fwd = 2 * B * S * C * W, 2 * B * S * C * W // C
    if kind == "decode":
        return {}
    if kind == "prefill":
        return {"conv forward (repro divides by C)": L * (conv - repro_fwd)}
    fwd = 2 if kind == "train_remat" else 1
    return {"conv forward (repro divides by C)": L * fwd * (conv - repro_fwd),
            "conv gradients": L * (2 * conv - 2 * B * (S + W - 1) * C * W - conv)}


def _gaps(cfg, kind: str) -> dict:
    """Port flops minus ``repro``'s, by the op that differs."""
    nc = -(-S // cfg.ssm_chunk)
    Q = cfg.ssm_chunk
    fwd = 2 if kind == "train_remat" else 1
    if cfg.family == "hybrid":
        L, H, P, N = cfg.n_layers, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        gaps = _conv_gaps(L, cfg.d_inner_ssm + 2 * N, cfg.ssm_conv_width, kind)
        # repro's chunk-state and y_inter einsums, three operands each
        # ("bcqh,bcqhp,bcqn->bchpn", "bcqh,bcqn,bchpn->bcqhp",
        # src/repro/models/mamba2.py:109 and :129): opt_einsum takes the
        # (B,nc,Q,H) x (B,nc,Q,N) outer product first, a dot with no
        # contracting dim; the port's contract the states in another order
        # and multiply by exp(L) elementwise. Training takes both operands'
        # gradients too.
        outer = 2 * 2 * B * nc * Q * H * N
        if kind == "decode":
            # repro's state update einsum("bhp,bn->bhpn") (mamba2.py:172), a
            # dot with no contracting dim; the port's broadcasts
            return {"decode state outer product": -L * 2 * B * H * P * N}
        uses = 1 if kind == "prefill" else fwd + 2
        return {**gaps, "state and y_inter outer products": -L * uses * outer}
    if cfg.family == "ssm":
        d, di, H = cfg.d_model, cfg.ssm_expand * cfg.d_model, cfg.n_heads
        dh = di // H
        nb, nm = cfg.n_layers // cfg.slstm_period, cfg.slstm_period - 1
        Lm = nb * nm
        gaps = _conv_gaps(Lm, di, cfg.ssm_conv_width, kind)
        # sLSTM step: repro einsum("bhd,ghde->bghe") over R's four gates
        # (src/repro/models/xlstm.py:210); the port one product with the z and
        # o columns and the i/f head means (recurrent_weight): 2·B·H·dh·(2dh+2)
        rec_repro, rec_port = 2 * 4 * B * H * dh * dh, 2 * B * H * dh * (2 * dh + 2)
        u, s = 2 * B * Q * H * dh * dh, 2 * B * Q * H * dh
        if kind == "decode":
            # repro runs _mlstm_chunk at Q = 1: q·k, A·v, q·n, and the C and
            # n updates' products with wk are 1-row dots; the port's are
            # elementwise
            return {"sLSTM recurrent product": nb * (rec_port - rec_repro),
                    "mLSTM 1-row dots": -Lm * 5 * 2 * B * H * dh}
        if kind == "prefill":
            return {**gaps, "sLSTM recurrent product": nb * S * (rec_port - rec_repro),
                    # repro's wk_end·k (the C update's first contraction) and
                    # its n update einsum("bqh,bqhd->bhd") (xlstm.py:97-100)
                    "mLSTM carry dots": -Lm * nc * 2 * s,
                    # repro's prefill runs the in_proj twice (xlstm_model.py:157)
                    "repro's second in_proj": -Lm * 2 * B * S * d * 2 * di}
        # training: the port's sLSTM takes no gradient of the empty state's h;
        # repro transposes every step. Its mLSTM backward takes no gradient of
        # the first chunk's (empty) carry nor through the last chunk's carry
        # update (unused); repro's scan transposes every chunk: 3u + (4nc+1)s
        # fewer, and the 2s a chunk fewer of each forward
        return {**gaps,
                "sLSTM recurrent product": nb * ((3 * S - 1) * rec_port - 3 * S * rec_repro),
                "mLSTM carry dots": -Lm * (fwd * nc * 2 * s + 3 * u + (4 * nc + 1) * s)}
    return {}


REPRO_SIDE = textwrap.dedent("""
    import json, os, sys
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, sys.argv[1])
    import test_torch_costs as t
    print(json.dumps({f"{a} {k}": t._repro_costs(a, k) for a in t.ARCHS for k in t.KINDS}))
""")


@pytest.fixture(scope="module")
def both_sides():
    """Every case's counts: ``repro``'s traced in a child process while this
    process counts the port's."""
    proc = subprocess.Popen([sys.executable, "-c", REPRO_SIDE, os.path.dirname(__file__)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=os.path.abspath(REPO_SRC)))
    try:
        port = {f"{a} {k}": _port_costs(a, k) for a in ARCHS for k in KINDS}
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    repro = json.loads(out.strip().splitlines()[-1])
    return {case: (port[case], repro[case]) for case in port}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_step_costs_match_jaxpr_costs(both_sides, arch, kind):
    got, want = both_sides[f"{arch} {kind}"]
    gaps = _gaps(_cut(get_smoke(arch)), kind)
    assert got["flops"] - want["flops"] == sum(gaps.values()), (got, want, gaps)
    if arch == "qwen3-14b":
        assert got["dot_bytes"] == want["dot_bytes"]
    assert got["bytes"] > got["dot_bytes"] > 0


def test_collective_bytes_in_a_loop_on_a_fake_world(collectives_child):
    """7 all-reduces of f32[4] in a Python loop and one all-gather into
    f32[8] on a fake world of 2: 112 and 32 result bytes, 8 collectives
    (``repro``'s HLO parser case, its while loop a Python loop here)."""
    out, err = collectives_child.communicate(timeout=120)
    assert collectives_child.returncode == 0, err
    c = json.loads(out.strip().splitlines()[-1])
    assert c["all-reduce"] == 7 * 16 and c["all-gather"] == 32 and c["count"] == 8
    assert c["reduce-scatter"] == c["all-to-all"] == c["collective-permute"] == 0
