"""The port's backward paths (latent2im_tpu_torch/ops) against the JAX
package on the CPU, where each wrapper runs its plain PyTorch version
through the same autograd node it records on the card.

The Pallas kernels' VJPs run in interpret mode, as tests/test_ops_pallas.py
runs them. Tolerances, relative to max |reference|: fused_act dx 1e-6 (the
same f32 products), db 1e-5 (an f32 sum over rows in another order);
upfirdn2d 1e-5 (f32 sums of at most 16 taps); the styled conv 1e-5 against
autograd of its plain version (the same convs, summed in another order) and
2e-4 against jax.grad (a 9*Cin-term f32 sum, as tests/test_torch_ops.py
allows for the forward).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from latent2im_tpu.models import stylegan2 as jsg2
from latent2im_tpu.ops.pallas_kernels import (fused_leaky_relu_pallas,
                                              upfirdn2d_pallas)
from latent2im_tpu_torch import ops


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), err


# ---------------------------------------------------------------------------
# fused_act backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 128), (2, 4, 4, 128), (3, 5, 7, 16)])
def test_fused_act_backward_matches_pallas_vjp(shape):
    rng = np.random.RandomState(1)
    x = rng.randn(*shape).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    out, vjp = jax.vjp(fused_leaky_relu_pallas, jnp.asarray(x), jnp.asarray(b))
    dx_j, db_j = vjp(jnp.asarray(g))
    # the plain backward on the saved output
    dx, db = ops.fused_leaky_relu_bwd_plain(_t(g), _t(np.asarray(out)))
    _close(dx, dx_j, 1e-6)
    _close(db, db_j, 1e-5)
    # the wrapper's autograd node
    xt, bt = _t(x).requires_grad_(), _t(b).requires_grad_()
    y = ops.fused_leaky_relu(xt, bt)
    assert y.grad_fn is not None
    y.backward(_t(g))
    _close(xt.grad, dx_j, 1e-6)
    _close(bt.grad, db_j, 1e-5)


def test_fused_act_backward_bf16_and_without_bias():
    """bf16 g and output give the Pallas kernel's bf16 dx bit for bit (f32
    math, one rounding); without a bias only dx flows."""
    rng = np.random.RandomState(2)
    x = rng.randn(4, 8, 64).astype(np.float32)
    b = rng.randn(64).astype(np.float32)
    g = rng.randn(4, 8, 64).astype(np.float32)
    out, vjp = jax.vjp(fused_leaky_relu_pallas, jnp.asarray(x, jnp.bfloat16),
                       jnp.asarray(b))
    dx_j, _ = vjp(jnp.asarray(g, jnp.bfloat16))
    dx, _ = ops.fused_leaky_relu_bwd_plain(
        _t(g).bfloat16(), _t(np.asarray(out.astype(jnp.float32))).bfloat16())
    assert dx.dtype == torch.bfloat16
    np.testing.assert_array_equal(dx.float().numpy(),
                                  np.asarray(dx_j.astype(jnp.float32)))
    xt = _t(x).requires_grad_()
    ops.fused_leaky_relu(xt).backward(_t(g))
    v = np.where(x >= 0, 1.0, 0.2) * np.sqrt(2.0)
    _close(xt.grad, g * v, 1e-6)


# ---------------------------------------------------------------------------
# upfirdn2d backward
# ---------------------------------------------------------------------------

ASYM = np.arange(1, 13, dtype=np.float32).reshape(3, 4) ** 1.5  # catches flips

GRAD_CASES = [
    # (up, down, (px0, px1, py0, py1), taps, H, W, C):
    # the grid of tests/test_ops_pallas.py:58
    (1, 1, (1, 1, 1, 1), [1, 3, 3, 1], 8, 8, 128),
    (2, 1, (2, 1, 2, 1), [1, 3, 3, 1], 8, 8, 128),
    (1, 2, (2, 2, 2, 2), [1, 3, 3, 1], 16, 16, 128),
    # the training path's sites: the D blur (pad 2, 2) before a 3x3 stride-2
    # conv and (pad 1, 1) before the 1x1 skip, the G up-conv blur
    (1, 1, (2, 2, 2, 2), [1, 3, 3, 1], 8, 8, 16),
    (1, 1, (1, 1, 1, 1), [1, 3, 3, 1], 9, 9, 16),
    # (H*up + p0 + p1 - k) % down != 0: the forward drops trailing samples
    (1, 2, (1, 1, 1, 1), [1, 3, 3, 1], 9, 9, 8),
    # an asymmetric kernel, four distinct pads, crops, up and down
    (2, 1, (2, 1, 0, 3), ASYM, 6, 5, 8),
    (1, 2, (-1, 2, 3, 0), ASYM, 11, 9, 8),
    (2, 2, (1, 1, 1, 1), [1, 3, 3, 1], 8, 10, 8),
]


@pytest.mark.parametrize("up,down,pad,taps,h,w,c", GRAD_CASES)
def test_upfirdn2d_backward_matches_pallas_vjp(up, down, pad, taps, h, w, c):
    rng = np.random.RandomState(3)
    k = np.asarray(taps, np.float32)
    k = ops.make_kernel(k) if k.ndim == 1 else k / k.sum()
    x = rng.randn(2, h, w, c).astype(np.float32)
    px0, px1, py0, py1 = pad
    out, vjp = jax.vjp(
        lambda xx: upfirdn2d_pallas(xx, jnp.asarray(k), up, up, down, down,
                                    px0, px1, py0, py1),
        jnp.asarray(x))
    g = rng.randn(*out.shape).astype(np.float32)
    (dx_j,) = vjp(jnp.asarray(g))
    # the backward wrapper: the same op with the transposed parameters
    _close(ops.upfirdn2d_bwd(_t(g), k, up, down, pad, (h, w)), dx_j, 1e-5)
    # and the wrapper's autograd node
    xt = _t(x).requires_grad_()
    y = ops.upfirdn2d(xt, k, up=up, down=down, pad=pad)
    assert y.grad_fn is not None and tuple(y.shape) == out.shape
    y.backward(_t(g))
    _close(xt.grad, dx_j, 1e-5)


def test_upfirdn2d_transposed_params():
    """The backward of the x2 skip upsample is a stride-2 FIR with the
    flipped kernel; the transposed op always gives back the input's size."""
    assert ops.transposed_params((4, 4), 2, 1, (2, 1), (8, 8), (16, 16)) == \
        (1, 2, (1, 1, 1, 1))
    with pytest.raises(ValueError, match="does not come from"):
        ops.transposed_params((4, 4), 1, 1, (1, 1), (9, 9), (9, 9))


# ---------------------------------------------------------------------------
# styled conv backward (library calls around the fused_act backward)
# ---------------------------------------------------------------------------


def _styled_operands(b=2, hw=8, cin=12, cout=16, style_dim=8, noise_b=1, seed=0):
    rng = np.random.RandomState(seed)
    p = {
        "conv": {"w": rng.randn(3, 3, cin, cout).astype(np.float32),
                 "mod": {"w": rng.randn(style_dim, cin).astype(np.float32),
                         "b": (1.0 + 0.1 * rng.randn(cin)).astype(np.float32)}},
        "noise_w": np.float32(0.7),
        "act_b": (0.1 * rng.randn(cout)).astype(np.float32),
    }
    x = rng.randn(b, hw, hw, cin).astype(np.float32)
    style = rng.randn(b, style_dim).astype(np.float32)
    noise = rng.randn(noise_b, hw, hw, 1).astype(np.float32)
    g = rng.randn(b, hw, hw, cout).astype(np.float32)
    return p, x, style, noise, g


def _port_styled(p, x, style, noise):
    """The port's StyledConv arithmetic on leaf tensors (x, style, noise_w,
    bias): s and d as models/stylegan2.py builds them, then the wrapper."""
    cin = p["conv"]["w"].shape[2]
    scale = 1.0 / np.sqrt(9 * cin)
    leaves = {"x": _t(x), "style": _t(style),
              "noise_w": torch.tensor([float(p["noise_w"])]),
              "bias": _t(p["act_b"])}
    for v in leaves.values():
        v.requires_grad_()
    wm, bm = _t(p["conv"]["mod"]["w"]), _t(p["conv"]["mod"]["b"])
    s = leaves["style"] @ (wm / np.sqrt(wm.shape[0])) + bm
    w = _t(p["conv"]["w"])
    d = torch.rsqrt(scale * scale * (s.square() @ w.square().sum((0, 1))) + 1e-8)
    out = ops.styled_conv3x3(leaves["x"], (w * scale).contiguous(), s, d,
                             _t(noise[..., 0]), leaves["noise_w"], leaves["bias"])
    return out, leaves


@pytest.mark.parametrize("noise_b", [1, 2])
def test_styled_conv_backward_matches_jax_grad(noise_b):
    p, x, style, noise, g = _styled_operands(noise_b=noise_b)
    pj = jax.tree_util.tree_map(jnp.asarray, p)

    def f(xx, st, nw, ab):
        q = {**pj, "noise_w": nw, "act_b": ab}
        return jnp.sum(jsg2.styled_conv(q, xx, st, jnp.asarray(noise)) * g)

    want = jax.grad(f, argnums=(0, 1, 2, 3))(
        jnp.asarray(x), jnp.asarray(style), pj["noise_w"], pj["act_b"])
    out, leaves = _port_styled(p, x, style, noise)
    assert out.grad_fn is not None
    out.backward(_t(g))
    for name, wj in zip(("x", "style", "noise_w", "bias"), want):
        _close(leaves[name].grad.reshape(np.shape(wj)), wj, 2e-4)


def test_styled_conv_backward_matches_autograd_of_plain():
    """Every operand's gradient (but the weight's) from the Function, with
    the plain forward plugged in, against autograd through the plain
    version; Cin != Cout, per-sample noise."""
    rng = np.random.RandomState(5)
    b, h, w_, cin, cout = 2, 5, 7, 6, 10
    base = {
        "x": rng.randn(b, h, w_, cin), "s": 1.0 + 0.2 * rng.randn(b, cin),
        "d": 0.5 + rng.rand(b, cout), "noise": rng.randn(b, h, w_),
        "noise_w": np.asarray([0.3]), "bias": 0.1 * rng.randn(cout),
    }
    wt = _t((rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32))
    g = _t(rng.randn(b, h, w_, cout).astype(np.float32))
    grads = []
    for fn in (ops.styled_conv3x3, ops.styled_conv3x3_plain):
        leaves = {k: _t(v.astype(np.float32)).requires_grad_() for k, v in base.items()}
        fn(leaves["x"], wt, leaves["s"], leaves["d"], leaves["noise"],
           leaves["noise_w"], leaves["bias"]).backward(g)
        grads.append({k: v.grad for k, v in leaves.items()})
    for k in base:
        _close(grads[0][k], grads[1][k].numpy(), 1e-5)


def test_styled_conv_weight_gradient_is_refused():
    rng = np.random.RandomState(6)
    x = _t(rng.randn(1, 4, 4, 2).astype(np.float32))
    w = _t(rng.randn(3, 3, 2, 3).astype(np.float32)).requires_grad_()
    out = ops.styled_conv3x3(x, w, torch.ones(1, 2), torch.ones(1, 3), None,
                             torch.zeros(1), torch.zeros(3))
    with pytest.raises(NotImplementedError, match="updateGAN"):
        out.sum().backward()
