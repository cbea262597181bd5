"""The causal conv with its bias and SiLU (``kernels/causal_conv.py``) on the
CPU: the backward kernel's formula (its plain version) against autograd
through the plain forward, the card's route through ``kernels.ops`` with
its launchers stood in for by the plain versions, and the decode state's
conv tail of the Mamba2 mixer and the mLSTM against the padded form it
replaced. The kernels themselves run in ``tests/test_torch_cuda.py``."""

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F

from repro_torch.configs import get_smoke
from repro_torch.kernels import ops
from repro_torch.kernels.causal_conv import (
    causal_conv_silu_bwd_plain,
    causal_conv_silu_plain,
)
from repro_torch.models import mamba2, xlstm


def _inputs(seed, B, S, Ch, W, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g, dtype=dtype)
            for shape in ((B, S, Ch), (W, Ch), (Ch,), (B, S, Ch))]


@pytest.mark.parametrize("S,W", [(1, 4), (3, 4), (11, 4), (11, 2), (5, 1)])
def test_plain_backward_matches_autograd(S, W):
    """dx, dw and db of the kernel's formula against autograd through the
    plain forward, both in float64: equal within float64 rounding."""
    x, w, b, dy = _inputs(S * 10 + W, 2, S, 6, W)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    want = torch.autograd.grad(causal_conv_silu_plain(*leaves), leaves, dy)
    got = causal_conv_silu_bwd_plain(x, w, b, dy)
    for g, e in zip(got, want):
        assert g.dtype == e.dtype and g.shape == e.shape
        torch.testing.assert_close(g, e, rtol=1e-12, atol=1e-12)


def _card_route(monkeypatch):
    """``ops`` as on the card, its launchers the plain versions; each
    launcher's inputs recorded."""
    seen = []

    def fwd(x, w, b):
        seen.append(("fwd", x.stride()))
        return causal_conv_silu_plain(x, w, b)

    def bwd(x, w, b, dy):
        assert dy.stride(-1) == 1
        seen.append(("bwd", x.stride()))
        return causal_conv_silu_bwd_plain(x, w, b, dy)
    monkeypatch.setattr(ops, "_on_cuda", lambda t, what: True)
    monkeypatch.setattr(ops, "causal_conv_silu_triton", fwd)
    monkeypatch.setattr(ops, "causal_conv_silu_bwd_triton", bwd)
    ops.reset_launches()
    return seen


def test_card_route_counts_launches_and_keeps_the_gradients(monkeypatch):
    """Through the card's route: a strided slice goes to the launchers as it
    lies (no copy), one forward and one backward launch under autograd, one
    forward launch without it, and the gradients autograd gives through the
    plain forward."""
    x, w, b, dy = _inputs(3, 2, 9, 5, 4)
    wide = torch.cat([x, torch.zeros_like(x)], dim=-1)
    xs = wide[..., :5].requires_grad_()
    wg, bg = w.clone().requires_grad_(), b.clone().requires_grad_()
    seen = _card_route(monkeypatch)
    out = ops.causal_conv_silu(xs, wg, bg)
    dy_rows_apart = dy.transpose(0, 1).contiguous().transpose(0, 1)
    got = torch.autograd.grad(out, (xs, wg, bg), dy_rows_apart)
    with torch.no_grad():
        ops.causal_conv_silu(xs, wg, bg)
    assert seen == [("fwd", wide.stride()), ("bwd", wide.stride()), ("fwd", wide.stride())]
    assert ops.LAUNCHES["causal_conv_silu"] == 2 and ops.LAUNCHES["causal_conv_silu_bwd"] == 1
    monkeypatch.undo()
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    want = torch.autograd.grad(causal_conv_silu_plain(*leaves), leaves, dy)
    for g, e in zip(got, want):
        torch.testing.assert_close(g, e, rtol=1e-12, atol=1e-12)


def _old_tail(x, W):
    S = x.shape[1]
    return F.pad(x, (0, 0, max(0, W - 1 - S), 0))[:, -(W - 1):, :]


@pytest.mark.parametrize("S", [2, 3, 5])
def test_conv_tail_as_before(S):
    """The mixer's and the mLSTM's decode state keeps the last W-1 conv
    inputs, zeros in front where the prompt is shorter (S 2 < W-1 = 3), as
    the padded form gave."""
    cfg = get_smoke("zamba2-7b")
    g = torch.Generator().manual_seed(S)
    p = mamba2.mamba_init(g, cfg)
    x = torch.randn((2, S, cfg.d_model), generator=g)
    _, state = mamba2.mamba_forward(p, x, cfg)
    di, GN, W = cfg.d_inner_ssm, mamba2.groups(cfg) * cfg.ssm_state, cfg.ssm_conv_width
    xBC = mamba2.dense(p["in_proj"], x)[..., di:2 * di + 2 * GN]
    assert torch.equal(state.conv, _old_tail(xBC, W))

    xcfg = get_smoke("xlstm-1.3b")
    xp = xlstm.mlstm_init(g, xcfg)
    xx = torch.randn((2, S, xcfg.d_model), generator=g)
    _, xstate = xlstm.mlstm_forward(xp, xx, xcfg)
    x_in = mamba2.dense(xp["in_proj"], xx).chunk(2, dim=-1)[0]
    assert torch.equal(xstate.conv, _old_tail(x_in, xcfg.ssm_conv_width))
    assert xstate.conv.shape == (2, xcfg.ssm_conv_width - 1, x_in.shape[-1])

