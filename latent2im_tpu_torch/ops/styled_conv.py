"""Fused StyleGAN2 styled 3x3 conv: modulate -> conv -> demodulate -> noise ->
bias -> LeakyReLU * sqrt(2).

    out = lrelu(conv3x3_same(x * s, w) * d + noise_w * noise + bias) * sqrt(2)

The same function as the JAX package's ``models/stylegan2.py:styled_conv``
for a non-up 3x3 layer, and as its Pallas kernel
``ops/pair_conv.py:fused_styled_conv3x3_pair``. On a CUDA tensor
``styled_conv3x3`` launches the hand-written kernel
``csrc/styled_conv3x3.cu`` (3xTF32 on the tensor cores: a launch that
lays the weight out K-major, the product, and at the small resolutions a
split-K reduction launch); on a CPU tensor it runs the plain PyTorch
version. ``styled_conv3x3_tf32`` repeats the kernel's
numerics in plain PyTorch for the tests.

The TPU kernel is forward-only (JAX trains through its XLA form), so there is
no backward kernel to port. When an operand needs a gradient the wrapper
records an autograd node whose backward is device-agnostic torch code: the
fused_act backward (a kernel on cuda) on the saved output, then cuDNN convs
for the rest. The weight gradient is not written: G is frozen while a walk
trains.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from . import _build
from .fused_act import fused_leaky_relu_bwd

SQRT2 = math.sqrt(2.0)


def _conv(xs, w):
    """conv3x3_same of NHWC xs with [3, 3, Cin, Cout] w -> NHWC."""
    return F.conv2d(xs.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                    padding=1).permute(0, 2, 3, 1)


def _epilogue(y, d, noise, noise_w, bias, negative_slope, gain):
    out = y * d[:, None, None, :]
    if noise is not None:
        out = out + noise_w * noise[..., None]
    out = out + bias
    return (torch.where(out >= 0, out, out * negative_slope) * gain).contiguous()


def styled_conv3x3_plain(x, w, s, d, noise, noise_w, bias,
                         negative_slope: float = 0.2, gain: float = SQRT2):
    """Plain PyTorch version (same operands as ``styled_conv3x3``)."""
    return _epilogue(_conv(x * s[:, None, None, :], w), d, noise, noise_w,
                     bias, negative_slope, gain)


def tf32_round(t):
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from zero,
    as ``cvt.rna.tf32.f32`` rounds: add half of the 13 dropped bits' range to
    the magnitude, then clear them."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(t):
    """t = big + small (to within 2^-22 of |t|), both TF32."""
    big = tf32_round(t)
    return big, tf32_round(t - big)


def styled_conv3x3_tf32(x, w, s, d, noise, noise_w, bias,
                        negative_slope: float = 0.2, gain: float = SQRT2,
                        passes: int = 3):
    """The CUDA kernel's numerics in plain PyTorch (f32 operands): x * s and
    w split into TF32 halves; passes=3 sums the products small*big +
    big*small + big*big (3xTF32, what the kernel computes), passes=1 only
    big*big (single-pass TF32). TF32 products are exact in f32, so f32
    convolutions of the halves give the tensor cores' products; their sums
    round as f32 adds do, not with the tensor cores' truncating
    accumulation, which this does not model. For tests."""
    (ab, al), (bb, bl) = tf32_split(x * s[:, None, None, :]), tf32_split(w)
    if passes == 1:
        y = _conv(ab, bb)
    elif passes == 3:
        y = _conv(al, bb) + _conv(ab, bl) + _conv(ab, bb)
    else:
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    return _epilogue(y, d, noise, noise_w, bias, negative_slope, gain)


@functools.lru_cache(maxsize=None)
def styled_conv3x3_plan(b: int, h: int, w: int, cin: int, cout: int) -> dict:
    """The CUDA kernel's tiling for a shape: {"tile": (BM, BN), "splits": S,
    "workspace_floats": n}, the workspace holding the K-major weight and,
    with S > 1 (split K, a last launch reduces), the partial sums. Cached
    per shape; do not modify the result."""
    plan = (ctypes.c_int * 3)()
    n = _build.library().l2i_styled_conv3x3_plan(b, h, w, cin, cout,
                                                  ctypes.addressof(plan))
    return {"tile": (plan[0], plan[1]), "splits": plan[2], "workspace_floats": n}


def _check_operands(x, w, s, d, noise, noise_w, bias):
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    expect = {"w": (3, 3, cin, cout), "s": (b, cin), "d": (b, cout),
              "noise_w": (1,), "bias": (cout,)}
    operands = {"x": x, "w": w, "s": s, "d": d, "noise_w": noise_w.reshape(1),
                "bias": bias}
    if noise is not None:
        if noise.dim() != 3 or noise.shape[0] not in (1, b) or \
                noise.shape[1:] != (h, wd):
            raise ValueError(
                f"styled_conv3x3: noise must be [1|{b}, {h}, {wd}], got "
                f"{tuple(noise.shape)}"
            )
        operands["noise"] = noise
    for name, t in operands.items():
        if name in expect and tuple(t.shape) != expect[name]:
            raise ValueError(
                f"styled_conv3x3: {name} must be {expect[name]}, got "
                f"{tuple(t.shape)}"
            )
        if t.device != x.device or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(
                f"styled_conv3x3: {name} must be contiguous f32 on {x.device}"
            )
    return operands["noise_w"]


def _forward(x, w, s, d, noise, noise_w, bias, negative_slope, gain):
    if x.device.type == "cpu":
        return styled_conv3x3_plain(x, w, s, d, noise, noise_w, bias,
                                    negative_slope, gain)
    noise_w = _check_operands(x, w, s, d, noise, noise_w, bias)
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    out = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    n_ws = styled_conv3x3_plan(b, h, wd, cin, cout)["workspace_floats"]
    ws = torch.empty(n_ws, dtype=x.dtype, device=x.device)
    rc = _build.library().l2i_styled_conv3x3(
        x.data_ptr(), w.data_ptr(), s.data_ptr(), d.data_ptr(),
        _build.ptr(noise), noise_w.data_ptr(), bias.data_ptr(),
        out.data_ptr(), ws.data_ptr(), b, h, wd, cin, cout,
        int(noise is not None and noise.shape[0] == b and b > 1),
        negative_slope, gain, _build.stream_of(x),
    )
    _build.check(rc, "styled_conv3x3")
    styled_conv3x3.launches += 1
    return out


def _nchw(t):
    """NHWC -> the NCHW view cuDNN takes (channels_last memory, no copy)."""
    return t.permute(0, 3, 1, 2)


class _StyledConv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, s, d, noise, noise_w, bias, negative_slope, gain):
        out = _forward(x, w, s, d, noise, noise_w, bias, negative_slope, gain)
        ctx.save_for_backward(x, w, s, d, noise, noise_w, out)
        ctx.negative_slope, ctx.gain = negative_slope, gain
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, s, d, noise, noise_w, out = ctx.saved_tensors
        need = ctx.needs_input_grad
        if need[1]:
            raise NotImplementedError(
                "styled_conv3x3: the weight gradient is not written; G trains "
                "only under --updateGAN (ROADMAP.md queue A item 11)"
            )
        # gradient at the pre-activation z = y * d + noise_w * noise + bias
        gz, _ = fused_leaky_relu_bwd(g.contiguous(), out, ctx.negative_slope,
                                     ctx.gain, bias_grad=False)
        gx = gs = gd = gnoise = gnw = gbias = None
        if need[6]:
            gbias = gz.sum((0, 1, 2))
        if noise is not None and (need[4] or need[5]):
            gz_c = gz.sum(-1)  # [B, H, W]
            if need[5]:
                gnw = (gz_c * noise).sum().reshape(noise_w.shape)
            if need[4]:
                gnoise = (gz_c * noise_w.reshape(())).sum(0, keepdim=True) \
                    if noise.shape[0] == 1 else gz_c * noise_w.reshape(())
        w_oihw = w.permute(3, 2, 0, 1)
        if need[3]:
            y = F.conv2d(_nchw(x * s[:, None, None, :]), w_oihw, padding=1)
            gd = (gz * y.permute(0, 2, 3, 1)).sum((1, 2))
        if need[0] or need[2]:
            gy = gz * d[:, None, None, :]
            gxs = torch.nn.grad.conv2d_input(
                _nchw(x).shape, w_oihw, _nchw(gy), padding=1).permute(0, 2, 3, 1)
            if need[0]:
                gx = gxs * s[:, None, None, :]
            if need[2]:
                gs = (gxs * x).sum((1, 2))
        return gx, None, gs, gd, gnoise, gnw, gbias, None, None


def styled_conv3x3(x, w, s, d, noise, noise_w, bias,
                   negative_slope: float = 0.2, gain: float = SQRT2):
    """x [B,H,W,Cin] NHWC; w [3,3,Cin,Cout] pre-scaled by 1/sqrt(9 Cin);
    s [B,Cin] modulation; d [B,Cout] demodulation; noise [1|B,H,W] or None;
    noise_w a 1-element tensor; bias [Cout]. Returns [B,H,W,Cout].
    Differentiable in every operand but w."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"styled_conv3x3: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, w, s, d, noise, noise_w, bias)):
        return _StyledConv3x3.apply(x, w, s, d, noise, noise_w, bias,
                                    negative_slope, gain)
    return _forward(x, w, s, d, noise, noise_w, bias, negative_slope, gain)


styled_conv3x3.launches = 0
