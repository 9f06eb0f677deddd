"""Fused StyleGAN2 styled 3x3 conv: modulate -> conv -> demodulate -> noise ->
bias -> LeakyReLU * sqrt(2), forward only.

    out = lrelu(conv3x3_same(x * s, w) * d + noise_w * noise + bias) * sqrt(2)

The same function as the JAX package's ``models/stylegan2.py:styled_conv``
for a non-up 3x3 layer, and as its Pallas kernel
``ops/pair_conv.py:fused_styled_conv3x3_pair``. On a CUDA tensor
``styled_conv3x3`` launches the hand-written kernel
``csrc/styled_conv3x3.cu``; on a CPU tensor it runs the plain PyTorch version.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _build

SQRT2 = math.sqrt(2.0)


def styled_conv3x3_plain(x, w, s, d, noise, noise_w, bias,
                         negative_slope: float = 0.2, gain: float = SQRT2):
    """Plain PyTorch version (same operands as ``styled_conv3x3``)."""
    xs = (x * s[:, None, None, :]).permute(0, 3, 1, 2)
    out = F.conv2d(xs, w.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    out = out * d[:, None, None, :]
    if noise is not None:
        out = out + noise_w * noise[..., None]
    out = out + bias
    return (torch.where(out >= 0, out, out * negative_slope) * gain).contiguous()


def styled_conv3x3(x, w, s, d, noise, noise_w, bias,
                   negative_slope: float = 0.2, gain: float = SQRT2):
    """x [B,H,W,Cin] NHWC; w [3,3,Cin,Cout] pre-scaled by 1/sqrt(9 Cin);
    s [B,Cin] modulation; d [B,Cout] demodulation; noise [1|B,H,W] or None;
    noise_w a 1-element tensor; bias [Cout]. Returns [B,H,W,Cout]."""
    if x.device.type == "cpu":
        return styled_conv3x3_plain(x, w, s, d, noise, noise_w, bias,
                                    negative_slope, gain)
    if x.device.type != "cuda":
        raise ValueError(f"styled_conv3x3: unsupported device {x.device}")
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
    out = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    lib = _build.library()
    rc = lib.l2i_styled_conv3x3(
        x.data_ptr(), w.data_ptr(), s.data_ptr(), d.data_ptr(),
        _build.ptr(noise), operands["noise_w"].data_ptr(), bias.data_ptr(),
        out.data_ptr(), b, h, wd, cin, cout,
        int(noise is not None and noise.shape[0] == b and b > 1),
        negative_slope, gain, _build.stream_of(x),
    )
    _build.check(rc, "styled_conv3x3")
    styled_conv3x3.launches += 1
    return out


styled_conv3x3.launches = 0
