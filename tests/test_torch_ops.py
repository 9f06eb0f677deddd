"""The port's kernel modules (latent2im_tpu_torch/ops) against the JAX
package on the CPU, where each wrapper runs its plain PyTorch version.

Inputs come from a numpy seed and go through both packages. The Pallas
kernels run in interpret mode, as tests/test_ops_pallas.py runs them.
Tolerances: fused_act 1e-6 (same f32 arithmetic, elementwise), upfirdn2d
1e-5 (f32 sums of at most 16 taps against the f64 oracle), styled conv 2e-4
(a 9*Cin-term f32 sum in another order, as tests/test_pair_conv.py allows).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from latent2im_tpu.models import stylegan2 as jsg2
from latent2im_tpu.ops import fused_leaky_relu as j_flrelu
from latent2im_tpu.ops import make_kernel as j_make_kernel
from latent2im_tpu.ops import upfirdn2d as j_upfirdn2d
from latent2im_tpu.ops import upfirdn2d_ref
from latent2im_tpu.ops import upfirdn2d_mod as j_ufd
from latent2im_tpu.ops.pallas_kernels import (fused_leaky_relu_pallas,
                                              upfirdn2d_pallas)
from latent2im_tpu_torch import ops


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# fused bias + LeakyReLU * sqrt(2)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,with_bias", [
    ((2, 4, 4, 128), True), ((3, 512), True), ((2, 5, 7, 3), False),
])
def test_fused_act_matches_jax_and_pallas(shape, with_bias):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32) if with_bias else None
    got = ops.fused_leaky_relu(_t(x), None if b is None else _t(b)).numpy()
    want = np.asarray(j_flrelu(jnp.asarray(x), None if b is None else jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    bp = np.zeros(shape[-1], np.float32) if b is None else b
    pallas = np.asarray(fused_leaky_relu_pallas(jnp.asarray(x), jnp.asarray(bp)))
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)


def test_fused_act_bf16_matches_pallas():
    """bf16 in and out, f32 math inside: the Pallas kernel's contract."""
    rng = np.random.RandomState(1)
    x = rng.randn(4, 8, 64).astype(np.float32)
    b = rng.randn(64).astype(np.float32)
    got = ops.fused_leaky_relu(_t(x).bfloat16(), _t(b))
    assert got.dtype == torch.bfloat16
    want = fused_leaky_relu_pallas(jnp.asarray(x, jnp.bfloat16), jnp.asarray(b))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# upfirdn2d
# ---------------------------------------------------------------------------

ASYM = np.arange(1, 13, dtype=np.float32).reshape(3, 4) ** 1.5  # catches flips

CASES = [
    # (up, down, pad, kernel, H, W, C): tests/test_upfirdn2d.py:31 grid
    (1, 1, (1, 1), [1, 3, 3, 1], 8, 8, 5),
    (1, 1, (2, 1), [1, 3, 3, 1], 9, 7, 5),
    (2, 1, (2, 1), [1, 3, 3, 1], 8, 8, 5),
    (1, 2, (2, 2), [1, 3, 3, 1], 16, 16, 5),
    (1, 2, (1, 1), [1, 3, 3, 1], 16, 16, 5),
    (2, 1, (1, 1), [1, 2, 1], 8, 8, 5),
    (1, 1, (-1, 2), [1, 3, 3, 1], 12, 12, 5),
    (2, 2, (1, 1), [1, 3, 3, 1], 8, 10, 5),
    # the slice's own sites: the up-conv blur (2H+1 -> 2H) and the C=3 skip
    (1, 1, (1, 1), [1, 3, 3, 1], 9, 9, 16),
    (2, 1, (2, 1), [1, 3, 3, 1], 8, 8, 3),
    # asymmetric kernel and four distinct pads: a double flip or a swapped
    # pad cannot pass
    (2, 1, (2, 1, 0, 3), ASYM, 6, 5, 3),
    (1, 2, (-1, 2, 3, 0), ASYM, 11, 9, 2),
]


@pytest.mark.parametrize("up,down,pad,taps,h,w,c", CASES)
def test_upfirdn2d_matches_f64_oracle(up, down, pad, taps, h, w, c):
    rng = np.random.RandomState(0)
    x = rng.randn(2, h, w, c).astype(np.float32)
    k = np.asarray(taps, np.float32)
    k = j_make_kernel(k) if k.ndim == 1 else k / k.sum()
    want = upfirdn2d_ref(x, k, up=up, down=down, pad=pad)
    got = ops.upfirdn2d(_t(x), k, up=up, down=down, pad=pad).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("up,down,pad,c", [
    # tests/test_ops_pallas.py:59 grid, plus C = 3 (no channel gate here)
    (1, 1, (1, 1), 128), (2, 1, (2, 1), 128), (1, 2, (2, 2), 128),
    (2, 1, (2, 1), 3),
])
def test_upfirdn2d_matches_pallas(up, down, pad, c):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 8, c).astype(np.float32)
    k = j_make_kernel([1, 3, 3, 1])
    want = np.asarray(upfirdn2d_pallas(jnp.asarray(x), jnp.asarray(k), up, up,
                                       down, down, pad[0], pad[1], pad[0], pad[1]))
    got = ops.upfirdn2d(_t(x), k, up=up, down=down, pad=pad).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_make_kernel_and_resampling_conventions():
    """make_kernel, upsample2d / downsample2d / blur2d pads and gains
    (blur2d scales the kernel by factor**2) equal the JAX package's."""
    k = ops.make_kernel([1, 3, 3, 1])
    np.testing.assert_array_equal(k, j_make_kernel([1, 3, 3, 1]))
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    xj, xt = jnp.asarray(x), _t(x)
    pairs = [
        (ops.upsample2d(xt, k), j_ufd.upsample2d(xj, jnp.asarray(k))),
        (ops.downsample2d(xt, k), j_ufd.downsample2d(xj, jnp.asarray(k))),
        (ops.blur2d(xt, k, pad=(2, 1), upsample_factor=2),
         j_ufd.blur2d(xj, jnp.asarray(k), pad=(2, 1), upsample_factor=2)),
        (ops.blur2d(xt, k, pad=(1, 1)), j_upfirdn2d(xj, jnp.asarray(k), pad=(1, 1))),
    ]
    for got, want in pairs:
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# styled 3x3 conv
# ---------------------------------------------------------------------------


def _styled_setup(b=2, hw=32, c=64, style_dim=32, seed=0):
    rng = np.random.RandomState(seed)
    p = {
        "conv": {
            "w": rng.randn(3, 3, c, c).astype(np.float32),
            "mod": {"w": rng.randn(style_dim, c).astype(np.float32),
                    "b": (1.0 + 0.1 * rng.randn(c)).astype(np.float32)},
        },
        "noise_w": np.float32(0.7),
        "act_b": (0.1 * rng.randn(c)).astype(np.float32),
    }
    x = rng.randn(b, hw, hw, c).astype(np.float32)
    style = rng.randn(b, style_dim).astype(np.float32)
    return p, x, style


def _jax_operands(p, style):
    """s, demod and the scaled weight exactly as the JAX package builds them
    (models/stylegan2.py:_styled_conv_pair)."""
    pj = {"w": jnp.asarray(p["conv"]["w"]),
          "mod": {k: jnp.asarray(v) for k, v in p["conv"]["mod"].items()}}
    c = p["conv"]["w"].shape[2]
    scale = 1.0 / np.sqrt(9 * c)
    s = jsg2.equal_linear(pj["mod"], jnp.asarray(style))
    w_sq = jnp.sum(jnp.square(pj["w"]), axis=(0, 1))
    demod = 1.0 / jnp.sqrt(scale * scale * (jnp.square(s) @ w_sq) + 1e-8)
    return (np.asarray(pj["w"] * scale), np.asarray(s), np.asarray(demod))


@pytest.mark.parametrize("noise_batch", [1, 2])
def test_styled_conv_matches_jax_pair_kernel_and_xla(noise_batch):
    p, x, style = _styled_setup()
    noise = np.random.RandomState(9).randn(noise_batch, 32, 32, 1).astype(np.float32)
    pj = {"conv": {"w": jnp.asarray(p["conv"]["w"]),
                   "mod": {k: jnp.asarray(v) for k, v in p["conv"]["mod"].items()}},
          "noise_w": jnp.asarray(p["noise_w"]), "act_b": jnp.asarray(p["act_b"])}
    want_xla = np.asarray(jsg2.styled_conv(pj, jnp.asarray(x), jnp.asarray(style),
                                           jnp.asarray(noise)))
    want_pair = np.asarray(jsg2._styled_conv_pair(
        pj, jnp.asarray(x), jnp.asarray(style), jnp.asarray(noise)))
    w, s, d = _jax_operands(p, style)
    got = ops.styled_conv3x3(
        _t(x), _t(w), _t(s), _t(d), _t(noise[..., 0]),
        torch.tensor([p["noise_w"]]), _t(p["act_b"]),
    ).numpy()
    np.testing.assert_allclose(got, want_xla, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, want_pair, rtol=2e-4, atol=2e-4)


def test_styled_conv_without_noise_and_ragged_channels():
    """noise=None drops the noise term; Cin != Cout and odd H, W work."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    w = (rng.randn(3, 3, 3, 5) / np.sqrt(27)).astype(np.float32)
    s = rng.rand(2, 3).astype(np.float32) + 0.5
    d = rng.rand(2, 5).astype(np.float32) + 0.5
    bias = rng.randn(5).astype(np.float32)
    got = ops.styled_conv3x3(_t(x), _t(w), _t(s), _t(d), None,
                             torch.tensor([0.3]), _t(bias)).numpy()
    xp = np.pad(x * s[:, None, None, :], ((0, 0), (1, 1), (1, 1), (0, 0)))
    conv = sum(np.einsum("bhwi,io->bhwo", xp[:, ky:ky + 5, kx:kx + 7], w[ky, kx])
               for ky in range(3) for kx in range(3))
    v = conv * d[:, None, None, :] + bias
    want = np.where(v >= 0, v, 0.2 * v) * np.sqrt(2)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
