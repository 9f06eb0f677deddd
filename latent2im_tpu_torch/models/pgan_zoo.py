"""The pytorch_GAN_zoo progressive GAN ("PGAN", the torch.hub model the
reference's pggan engine loads by default, pggan transform_base.py:554-566)
— PyTorch port of latent2im_tpu/models/pgan_zoo.py.

GNet: pixel norm on z, an equalized linear "format layer" to 4x4 x depth0,
LeakyReLU(0.2), pixel norm, the 3x3 equalized convs of scale 0, then per
scale a nearest x2 upsample and two 3x3 equalized convs (LeakyReLU(0.2),
then pixel norm, after each), a 1x1 ``toRGB`` per scale, and the alpha
blend of the previous scale during fade-in (alpha 0: fully grown). DNet: a
1x1 ``fromRGB`` per scale, per scale two 3x3 equalized convs and 2x2
average pooling, the minibatch-std channel (contiguous groups of up to 4,
unbiased variance + 1e-8), a 3x3 conv, the channel-major flatten, an
equalized linear and the decision layer. Equalized layers apply
sqrt(2 / fan_in) at run time.

Parameter names are the zoo's: ``formatLayer.module.*``,
``groupScale0.N.module.*``, ``scaleLayers.S.N.module.*``,
``toRGBLayers.S.module.*``; ``fromRGBLayers.S.module.*``,
``groupScaleZero.{0,1}.module.*``, ``decisionLayer.module.*``. The depth
ladder is read from the shapes (``from_state_dict``). Public tensors are
NHWC; the models compute in NCHW, the equalized convs as one GEMM over
their unfolded patches (``pggan.conv2d``, which says why).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import hooks
from .pggan import conv2d, pixel_norm, strip_module_prefix

CELEBAHQ_512_DEPTHS = (512, 512, 512, 512, 256, 128, 64, 32)


class _Wrapped(nn.Module):
    """The zoo's ConstrainedLayer: the raw layer under ``module``, N(0, 1)
    weights and zero biases, scaled by sqrt(2 / fan_in) at run time."""

    def __init__(self, layer: nn.Module, fan_in: int, generator=None):
        super().__init__()
        self.module = layer
        with torch.no_grad():
            layer.weight.copy_(torch.randn(layer.weight.shape, generator=generator))
            layer.bias.zero_()
        self.scale = math.sqrt(2.0 / fan_in)


class EqConv2d(_Wrapped):
    def __init__(self, cin, cout, k, padding, generator=None):
        super().__init__(nn.Conv2d(cin, cout, k, padding=padding), cin * k * k, generator)
        self.padding = padding

    def forward(self, x, plan=None):
        """plan: x holds this rank's rows (pggan.EqualConv2d's rule)."""
        w = self.module.weight * self.scale
        if plan is None:
            return conv2d(x, w, self.module.bias, self.padding)
        return conv2d(plan.halo(x, self.padding, dim=2), w, self.module.bias, (0, self.padding))


class EqLinear(_Wrapped):
    def __init__(self, din, dout, generator=None):
        super().__init__(nn.Linear(din, dout), din, generator)

    def forward(self, x):
        return F.linear(x, (self.module.weight * self.scale).to(x.dtype),
                        self.module.bias.to(x.dtype))


def _leaky(x):
    return F.leaky_relu(x, 0.2)


def _upscale(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _depths_from(sd, prefix: str, dim: int) -> list[int]:
    out, i = [], 0
    while f"{prefix}.{i}.module.weight" in sd:
        out.append(int(sd[f"{prefix}.{i}.module.weight"].shape[dim]))
        i += 1
    return out


class GNet(nn.Module):
    """depths[0] is the 4x4 depth; each later entry adds a x2 scale."""

    def __init__(self, dim_latent: int = 512, depths=CELEBAHQ_512_DEPTHS,
                 n_scale0: int = 1, generator=None):
        super().__init__()
        d0 = depths[0]
        self.formatLayer = EqLinear(dim_latent, d0 * 16, generator)
        self.groupScale0 = nn.ModuleList([EqConv2d(d0, d0, 3, 1, generator)
                                          for _ in range(n_scale0)])
        self.scaleLayers = nn.ModuleList()
        self.toRGBLayers = nn.ModuleList([EqConv2d(d0, 3, 1, 0, generator)])
        prev = d0
        for d in depths[1:]:
            self.scaleLayers.append(nn.ModuleList([EqConv2d(prev, d, 3, 1, generator),
                                                   EqConv2d(d, d, 3, 1, generator)]))
            self.toRGBLayers.append(EqConv2d(d, 3, 1, 0, generator))
            prev = d

    @classmethod
    def from_state_dict(cls, sd) -> "GNet":
        """A zoo GNet state_dict (``module.`` prefixes of DataParallel
        stripped) -> the GNet of its depth ladder, loaded strict."""
        from .pggan import load_strict

        sd = strip_module_prefix(sd)
        g = cls(int(sd["formatLayer.module.weight"].shape[1]),
                _depths_from(sd, "toRGBLayers", 1),
                n_scale0=len(_depths_from(sd, "groupScale0", 0)))
        load_strict(g, sd)
        return g

    @property
    def resolution(self) -> int:
        return 4 * 2 ** len(self.scaleLayers)

    def forward(self, z, alpha: float = 0.0, dtype: torch.dtype | None = None):
        """z [B, dim_latent] -> image [B, R, R, 3] NHWC f32, computed in
        ``dtype`` (the JAX package's ``dtype=``; None: z's own). 0 < alpha <
        1 blends the previous scale's rgb (GNet's fade-in); 0 is fully
        grown. Under a row plan the scales after the first whose output
        height qualifies run on this rank's rows (pggan.Generator's rule),
        and the image is gathered whole."""
        z = z if dtype is None else z.to(dtype)
        x = _leaky(self.formatLayer(pixel_norm(z, dim=-1)))
        x = pixel_norm(x.reshape(x.shape[0], -1, 4, 4))  # torch's (C, 4, 4) view
        for conv in self.groupScale0:
            x = pixel_norm(_leaky(conv(x)))
        prev_rgb = rows = None  # rows: the row plan, once x holds this rank's rows
        plan = hooks.row_plan()
        n = len(self.scaleLayers)
        for si, group in enumerate(self.scaleLayers):
            if si == n - 1 and 0 < alpha < 1:
                prev_rgb = _upscale(self.toRGBLayers[si](x))
            x = _upscale(x)
            for conv in group:
                x = pixel_norm(_leaky(conv(x, rows)))
            if rows is None and plan is not None and plan.qualifies(x.shape[2]):
                x, rows = plan.constrain(x, dim=2), plan
                if prev_rgb is not None:
                    prev_rgb = plan.constrain(prev_rgb, dim=2)
        out = self.toRGBLayers[-1](x)
        if prev_rgb is not None:
            out = alpha * prev_rgb + (1.0 - alpha) * out
        if rows is not None:
            out = plan.boundary(out, dim=2)
        return out.permute(0, 2, 3, 1).float()


def minibatch_stddev_zoo(x, sub_group_size: int = 4):
    """The zoo's miniBatchStdDev on NCHW: contiguous subgroups of
    min(B, 4) (the whole batch where that does not divide it), per group the
    unbiased std (+1e-8 under the root) averaged over C, H, W, each group's
    value given to its members as one more channel."""
    b, c, h, w = x.shape
    sub = min(b, sub_group_size)
    if b % sub != 0:
        sub = b
    if sub <= 1:
        return torch.cat([x, x.new_zeros((b, 1, h, w))], 1)
    y = x.reshape(b // sub, sub, c, h, w)
    std = torch.sqrt(torch.var(y, dim=1, unbiased=True) + 1e-8)
    stat = std.reshape(b // sub, -1).mean(1).repeat_interleave(sub)
    return torch.cat([x, stat.reshape(b, 1, 1, 1).expand(b, 1, h, w).to(x.dtype)], 1)


class DNet(nn.Module):
    def __init__(self, depths=CELEBAHQ_512_DEPTHS, decision_dim: int = 1,
                 minibatch_stddev: bool = True, generator=None):
        super().__init__()
        d0 = depths[0]
        self.fromRGBLayers = nn.ModuleList([EqConv2d(3, d, 1, 0, generator) for d in depths])
        self.scaleLayers = nn.ModuleList()
        prev = d0
        for d in depths[1:]:  # the shallowest scale first, as the zoo stores them
            self.scaleLayers.append(nn.ModuleList([EqConv2d(d, d, 3, 1, generator),
                                                   EqConv2d(d, prev, 3, 1, generator)]))
            prev = d
        extra = 1 if minibatch_stddev else 0
        self.groupScaleZero = nn.ModuleList([EqConv2d(d0 + extra, d0, 3, 1, generator),
                                             EqLinear(d0 * 16, d0, generator)])
        self.decisionLayer = EqLinear(d0, decision_dim, generator)

    def forward(self, img, dtype: torch.dtype | None = None):
        """img [B, R, R, 3] NHWC at the ladder's full resolution ->
        [B, decision_dim] f32, computed in ``dtype`` (None: the image's own)."""
        x = img if dtype is None else img.to(dtype)
        x = _leaky(self.fromRGBLayers[-1](x.permute(0, 3, 1, 2)))
        for group in reversed(self.scaleLayers):
            x = _leaky(group[0](x))
            x = _leaky(group[1](x))
            x = F.avg_pool2d(x, 2)
        conv = self.groupScaleZero[0].module
        if conv.in_channels == conv.out_channels + 1:  # the std channel
            x = minibatch_stddev_zoo(x)
        x = _leaky(self.groupScaleZero[0](x))
        x = _leaky(self.groupScaleZero[1](x.reshape(x.shape[0], -1)))  # channel-major
        return self.decisionLayer(x).float()
