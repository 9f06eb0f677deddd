"""Fused bias-add + LeakyReLU + gain, the StyleGAN2 activation, and its
gradient.

    y  = leaky_relu(x + bias, negative_slope) * scale       (scale = sqrt(2))
    dx = g * scale * (y > 0 ? 1 : negative_slope),   db = sum of dx over rows

The bias broadcasts over the LAST (channel) axis, as in the JAX package
(latent2im_tpu/ops/fused_act.py:fused_leaky_relu). The gradient is keyed on
the sign of the saved output, as in the TPU kernel's VJP
(ops/pallas_kernels.py:_flrelu_bwd).

On a CUDA tensor ``fused_leaky_relu`` launches the hand-written kernel
``csrc/fused_act.cu`` (the port of ``fused_leaky_relu_pallas``), and when its
input needs a gradient it records an autograd node whose backward,
``fused_leaky_relu_bwd``, launches the backward kernel of the same file. On a
CPU tensor both take their plain PyTorch versions below, through the same
autograd node.
"""

from __future__ import annotations

import math

import torch

from . import _build

SQRT2 = math.sqrt(2.0)


def _math_dtype(t):
    """f32 math for f32 and bf16 (the kernel's), f64 for an f64 reference."""
    return torch.promote_types(t.dtype, torch.float32)


def fused_leaky_relu_plain(x, bias=None, negative_slope: float = 0.2,
                           scale: float = SQRT2):
    """Plain PyTorch version: f32 (or f64) math, result in x's dtype."""
    v = x.to(_math_dtype(x))
    if bias is not None:
        v = v + bias.to(v.dtype)
    return (torch.where(v >= 0, v, v * negative_slope) * scale).to(x.dtype)


def fused_leaky_relu_bwd_plain(g, out, negative_slope: float = 0.2,
                               scale: float = SQRT2, bias_grad: bool = True):
    """Plain PyTorch backward -> (dx in g's dtype, db [C] in the math
    dtype, or None)."""
    dt = _math_dtype(g)
    gain = torch.where(out.to(dt) > 0, scale, scale * negative_slope).to(dt)
    dx = (g.to(dt) * gain).to(g.dtype)
    db = dx.to(dt).reshape(-1, dx.shape[-1]).sum(0) if bias_grad else None
    return dx, db


def _check_device(x, name):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def _forward(x, bias, negative_slope, scale):
    """The forward on x's device: the kernel on cuda, the plain version on
    the CPU."""
    if x.device.type == "cpu":
        return fused_leaky_relu_plain(x, bias, negative_slope, scale)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_leaky_relu: f32 or bf16 input, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_leaky_relu: input must be contiguous")
    c = x.shape[-1]
    if bias is not None:
        if bias.shape != (c,) or bias.device != x.device:
            raise ValueError(
                f"fused_leaky_relu: bias must be [{c}] on {x.device}, got "
                f"{tuple(bias.shape)} on {bias.device}"
            )
        bias = bias.float().contiguous()
    y = torch.empty_like(x)
    lib = _build.library()
    rc = lib.l2i_fused_act(
        x.data_ptr(), _build.ptr(bias), y.data_ptr(), x.numel(), c,
        int(x.dtype == torch.bfloat16), negative_slope, scale,
        _build.stream_of(x),
    )
    _build.check(rc, "fused_act")
    fused_leaky_relu.launches += 1
    return y


class _FusedLeakyReLU(torch.autograd.Function):
    """Forward: the kernel (or plain version); saves the output only."""

    @staticmethod
    def forward(ctx, x, bias, negative_slope, scale):
        out = _forward(x, bias, negative_slope, scale)
        ctx.save_for_backward(out)
        ctx.negative_slope, ctx.scale = negative_slope, scale
        ctx.bias_dtype = None if bias is None else bias.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        need_db = ctx.bias_dtype is not None and ctx.needs_input_grad[1]
        dx, db = fused_leaky_relu_bwd(g.contiguous(), out, ctx.negative_slope,
                                      ctx.scale, bias_grad=need_db)
        return dx, (db.to(ctx.bias_dtype) if need_db else None), None, None


def fused_leaky_relu(x, bias=None, negative_slope: float = 0.2,
                     scale: float = SQRT2):
    """y = leaky_relu(x + bias) * scale over [..., C], bias [C] or None.
    Differentiable in x and bias."""
    _check_device(x, "fused_leaky_relu")
    if torch.is_grad_enabled() and (
            x.requires_grad or (bias is not None and bias.requires_grad)):
        return _FusedLeakyReLU.apply(x, bias, negative_slope, scale)
    return _forward(x, bias, negative_slope, scale)


fused_leaky_relu.launches = 0


def fused_leaky_relu_bwd(g, out, negative_slope: float = 0.2,
                         scale: float = SQRT2, bias_grad: bool = True):
    """Gradient of ``fused_leaky_relu`` from its output ``out`` and the
    incoming gradient ``g`` (same shape [..., C]) -> (dx, db f32 [C] or
    None). On cuda dx comes from the backward kernel; db = dx summed over
    rows, a ``torch.sum`` as in the JAX package."""
    _check_device(g, "fused_leaky_relu_bwd")
    if g.device.type == "cpu":
        return fused_leaky_relu_bwd_plain(g, out, negative_slope, scale, bias_grad)
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_leaky_relu_bwd: f32 or bf16 input, got {g.dtype}")
    if out.shape != g.shape or out.dtype != g.dtype or out.device != g.device:
        raise ValueError(
            f"fused_leaky_relu_bwd: out must match g ({tuple(g.shape)} "
            f"{g.dtype} on {g.device}), got {tuple(out.shape)} {out.dtype} "
            f"on {out.device}"
        )
    if not (g.is_contiguous() and out.is_contiguous()):
        raise ValueError("fused_leaky_relu_bwd: g and out must be contiguous")
    dx = torch.empty_like(g)
    lib = _build.library()
    rc = lib.l2i_fused_act_bwd(
        g.data_ptr(), out.data_ptr(), dx.data_ptr(), g.numel(),
        int(g.dtype == torch.bfloat16), negative_slope, scale,
        _build.stream_of(g),
    )
    _build.check(rc, "fused_act_bwd")
    fused_leaky_relu_bwd.launches += 1
    db = dx.float().reshape(-1, dx.shape[-1]).sum(0) if bias_grad else None
    return dx, db


fused_leaky_relu_bwd.launches = 0
