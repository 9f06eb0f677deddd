"""Fused bias-add + LeakyReLU + gain, the StyleGAN2 activation.

    y = leaky_relu(x + bias, negative_slope) * scale        (scale = sqrt(2))

The bias broadcasts over the LAST (channel) axis, as in the JAX package
(latent2im_tpu/ops/fused_act.py:fused_leaky_relu). On a CUDA tensor the
wrapper launches the hand-written kernel ``csrc/fused_act.cu``, the port of
the TPU kernel ``ops/pallas_kernels.py:fused_leaky_relu_pallas``; on a CPU
tensor it runs the plain PyTorch version below. Forward only: the backward
kernel waits for the training slice.
"""

from __future__ import annotations

import math

import torch

from . import _build

SQRT2 = math.sqrt(2.0)


def fused_leaky_relu_plain(x, bias=None, negative_slope: float = 0.2,
                           scale: float = SQRT2):
    """Plain PyTorch version: f32 math, result in x's dtype."""
    v = x.float()
    if bias is not None:
        v = v + bias.float()
    return (torch.where(v >= 0, v, v * negative_slope) * scale).to(x.dtype)


def fused_leaky_relu(x, bias=None, negative_slope: float = 0.2,
                     scale: float = SQRT2):
    """y = leaky_relu(x + bias) * scale over [..., C], bias [C] or None."""
    if x.device.type == "cpu":
        return fused_leaky_relu_plain(x, bias, negative_slope, scale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_leaky_relu: unsupported device {x.device}")
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


fused_leaky_relu.launches = 0
