"""StyleGAN1-style progressive generator (the reference's 128/1024 px
'model.py' path), PyTorch port of latent2im_tpu/models/stylegan1.py.

Re-creates graphs/pggan/model.py:374-483: a style MLP (PixelNorm + 8x
EqualLinear/LeakyReLU) feeding AdaIN-modulated progressive StyledConvBlocks
with per-resolution noise injection, nearest or fused upsampling with a
fixed [1,2,1]^2/16 blur, a to_rgb per resolution, step/alpha fade-in, style
mixing and truncation.

Parameter names follow rosinality's style-based-gan-pytorch
(``StyledGenerator``: ``style.1.linear.weight_orig``,
``generator.progression.0.conv1.input``, ``...progression.5.conv1.0.weight``
(FusedUpsample), ``...progression.1.conv1.1.conv.weight_orig`` (nearest),
``...noise1.weight_orig``, ``...adain1.style.linear.weight_orig``,
``generator.to_rgb.N.conv.bias``; the Blur's ``weight``/``weight_flip``
buffers), so its checkpoints load with ``strict=True``;
io/convert.py:stylegan1_from_jax carries the JAX package's tree across.
Equalized learning rate: the stored weights are N(0, 1), scaled at run time
by sqrt(2 / fan_in). Whether block i upsamples fused is structural, as in
rosinality's Generator(fused=True): blocks from ``fused_from`` (5, 128 px)
on; the JAX package takes ``fused_from`` per call over the same weights.

Fused resampling (model.py:56-111): the weight padded by one and 4-tap
averaged (the 2x-resample-then-conv equivalence), applied as a stride-2
transposed conv (up, ``FusedUpsample``) or a stride-2 conv (down,
``FusedDownsample``, the reference's discriminator form).

Public tensors are NHWC, as in the JAX package: z [B, D] (or a list of them
for style mixing), noise maps [B, H, W, 1], images [B, H, W, 3] f32. No
entry point reaches this model and no kernel runs in it: its convolutions
are cuDNN's.

Under a row plan (models/hooks.py, parallel/spatial.py) the blocks after
the first whose output height qualifies run on this rank's rows (the JAX
package's hook after each block, models/stylegan1.py:249-277 there): the
3x3 pad-1 convs, the [1,2,1] blur and the fused upsample (a stride-2
transposed conv, whose output rows [2a, 2b) read input rows a-1..b) take
one halo row each side; the nearest upsampling, noise, LeakyReLU and the
1x1 rgb heads are row-local; AdaIN's instance norm takes its per-channel
sums (sum x, sum x^2) over the whole image in one all-reduce over the
spatial ranks; the rgb output is gathered whole.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import hooks

G_LADDER = [
    (512, 512), (512, 512), (512, 512), (512, 512),
    (512, 256), (256, 128), (128, 64), (64, 32), (32, 16),
]
FUSED_FROM = 5


def _randn(shape, generator):
    return torch.randn(shape, generator=generator)


class PixelNorm(nn.Module):
    def forward(self, x, eps: float = 1e-8):
        return x / torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)


class _EqualConv(nn.Module):
    """A conv whose stored ``weight_orig`` [out, in, k, k] is scaled by
    sqrt(2 / fan_in) per call (rosinality's equal_lr)."""

    def __init__(self, cin, cout, k, padding=0, generator=None):
        super().__init__()
        self.weight_orig = nn.Parameter(_randn((cout, cin, k, k), generator))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.padding = padding

    def forward(self, x, plan=None):
        scale = math.sqrt(2.0 / (self.weight_orig.shape[1] * self.weight_orig[0, 0].numel()))
        x, pad = _rows_in(x, self.padding, plan)
        return F.conv2d(x, self.weight_orig * scale, self.bias, padding=pad)


def _rows_in(x, padding: int, plan):
    """(x, the conv's padding): as is without a plan; with one (x holds
    this rank's rows) x with ``padding`` halo rows each side and the padding
    of the columns alone."""
    if plan is None or padding == 0:
        return x, padding
    return plan.halo(x, padding, dim=2), (0, padding)


class EqualConv2d(nn.Module):
    def __init__(self, cin, cout, k, padding=0, generator=None):
        super().__init__()
        self.conv = _EqualConv(cin, cout, k, padding, generator)

    def forward(self, x, plan=None):
        return self.conv(x, plan)


class _EqualLinear(nn.Module):
    def __init__(self, din, dout, generator=None):
        super().__init__()
        self.weight_orig = nn.Parameter(_randn((dout, din), generator))
        self.bias = nn.Parameter(torch.zeros(dout))

    def forward(self, x):
        scale = math.sqrt(2.0 / self.weight_orig.shape[1])
        return F.linear(x, self.weight_orig * scale, self.bias)


class EqualLinear(nn.Module):
    def __init__(self, din, dout, generator=None):
        super().__init__()
        self.linear = _EqualLinear(din, dout, generator)

    def forward(self, x):
        return self.linear(x)


def _avg4_pad(w):
    """Pad the kernel's two spatial axes by 1 and average the 4 shifted
    copies (model.py:72-79): [.., k, k] -> [.., k+1, k+1]."""
    wp = F.pad(w, (1, 1, 1, 1))
    return (wp[..., 1:, 1:] + wp[..., :-1, 1:] + wp[..., 1:, :-1] + wp[..., :-1, :-1]) / 4


class FusedUpsample(nn.Module):
    """2x upsample + conv as one stride-2 transposed conv of the 4-tap
    averaged weight ``weight`` [in, out, k, k]."""

    def __init__(self, cin, cout, k, padding=0, generator=None):
        super().__init__()
        self.weight = nn.Parameter(_randn((cin, cout, k, k), generator))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.multiplier = math.sqrt(2.0 / (cin * k * k))
        self.pad = padding

    def forward(self, x, plan=None):
        """plan: x holds this rank's rows [a, b); the output rows [2a, 2b)
        read input rows a-1..b: one halo row each side, the rows' padding
        cropped from the output instead."""
        w = _avg4_pad(self.weight * self.multiplier)
        if plan is None:
            return F.conv_transpose2d(x, w, self.bias, stride=2, padding=self.pad)
        h = x.shape[2]
        out = F.conv_transpose2d(plan.halo(x, 1, dim=2), w, self.bias, stride=2,
                                 padding=(0, self.pad))
        return out[:, :, 2 + self.pad:2 + self.pad + 2 * h]


class FusedDownsample(nn.Module):
    """conv + 2x downsample as one stride-2 conv of the 4-tap averaged
    weight ``weight`` [out, in, k, k]."""

    def __init__(self, cin, cout, k, padding=0, generator=None):
        super().__init__()
        self.weight = nn.Parameter(_randn((cout, cin, k, k), generator))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.multiplier = math.sqrt(2.0 / (cin * k * k))
        self.pad = padding

    def forward(self, x):
        w = _avg4_pad(self.weight * self.multiplier)
        return F.conv2d(x, w, self.bias, stride=2, padding=self.pad)


class Blur(nn.Module):
    """Depthwise fixed [1,2,1]^2/16 blur, pad 1 (model.py:122-178; the JAX
    package's ``blur3``)."""

    def __init__(self, channel):
        super().__init__()
        w = torch.tensor([[1.0, 2.0, 1.0], [2.0, 4.0, 2.0], [1.0, 2.0, 1.0]]).view(1, 1, 3, 3)
        w = w / w.sum()
        self.register_buffer("weight", w.repeat(channel, 1, 1, 1))
        self.register_buffer("weight_flip", torch.flip(w, [2, 3]).repeat(channel, 1, 1, 1))

    def forward(self, x, plan=None):
        x, pad = _rows_in(x, 1, plan)
        return F.conv2d(x, self.weight, padding=pad, groups=x.shape[1])


class NoiseInjection(nn.Module):
    """image + weight * noise, ``weight_orig`` [1, C, 1, 1] scaled by
    sqrt(2 / C) per call (equal_lr of a [1, C, 1, 1] weight)."""

    def __init__(self, channel):
        super().__init__()
        self.weight_orig = nn.Parameter(torch.zeros(1, channel, 1, 1))

    def forward(self, x, noise):
        scale = math.sqrt(2.0 / self.weight_orig.shape[1])
        return x + self.weight_orig * scale * noise


class ConstantInput(nn.Module):
    def __init__(self, channel, size=4, generator=None):
        super().__init__()
        self.input = nn.Parameter(_randn((1, channel, size, size), generator))

    def forward(self, batch: int):
        return self.input.expand(batch, -1, -1, -1)


class AdaptiveInstanceNorm(nn.Module):
    """Instance norm (eps 1e-5, biased variance), then the style's affine:
    gamma, beta = EqualLinear(style) split in two (model.py:267-285)."""

    def __init__(self, channel, style_dim, generator=None):
        super().__init__()
        self.norm = nn.InstanceNorm2d(channel)
        self.style = EqualLinear(style_dim, channel * 2, generator)
        with torch.no_grad():
            self.style.linear.bias[:channel] = 1
            self.style.linear.bias[channel:] = 0

    def forward(self, x, style, plan=None):
        """plan: x holds this rank's rows; the per-channel mean and biased
        variance come from (sum x, sum x^2) over every rank's rows, summed
        in f64 (E[x^2] - E[x]^2 cancels what f32 sums would keep)."""
        gamma, beta = self.style(style)[:, :, None, None].chunk(2, 1)
        if plan is None:
            return gamma * self.norm(x) + beta
        n = x.shape[2] * x.shape[3] * plan.n
        x64 = x.to(torch.float64)
        sums = plan.sum_rows(torch.stack([x64.sum((2, 3)), x64.square().sum((2, 3))]))
        mean = sums[0] / n
        rstd = torch.rsqrt(sums[1] / n - mean.square() + self.norm.eps)
        normed = (x - mean[:, :, None, None].to(x.dtype)) * rstd[:, :, None, None].to(x.dtype)
        return gamma * normed + beta


class StyledConvBlock(nn.Module):
    def __init__(self, cin, cout, style_dim=512, initial=False, upsample=False, fused=False,
                 generator=None):
        super().__init__()
        if initial:
            self.conv1 = ConstantInput(cin, generator=generator)
        elif upsample and fused:
            self.conv1 = nn.Sequential(FusedUpsample(cin, cout, 3, 1, generator), Blur(cout))
        elif upsample:
            self.conv1 = nn.Sequential(nn.Upsample(scale_factor=2, mode="nearest"),
                                       EqualConv2d(cin, cout, 3, 1, generator), Blur(cout))
        else:
            self.conv1 = EqualConv2d(cin, cout, 3, 1, generator)
        self.initial = initial
        self.noise1 = NoiseInjection(cout)
        self.adain1 = AdaptiveInstanceNorm(cout, style_dim, generator)
        self.conv2 = EqualConv2d(cout, cout, 3, 1, generator)
        self.noise2 = NoiseInjection(cout)
        self.adain2 = AdaptiveInstanceNorm(cout, style_dim, generator)

    def forward(self, x, style, noise, plan=None):
        """plan: x and noise hold this rank's rows (a row plan)."""
        if self.initial:
            out = self.conv1(style.shape[0])
        elif plan is None:
            out = self.conv1(x)
        else:
            out = x
            for layer in self.conv1:
                out = layer(out) if isinstance(layer, nn.Upsample) else layer(out, plan)
        out = F.leaky_relu(self.noise1(out, noise), 0.2)
        out = self.adain1(out, style, plan)
        out = F.leaky_relu(self.noise2(self.conv2(out, plan), noise), 0.2)
        return self.adain2(out, style, plan)


class Generator(nn.Module):
    def __init__(self, style_dim=512, fused_from: int = FUSED_FROM, generator=None):
        super().__init__()
        self.progression = nn.ModuleList([
            StyledConvBlock(cin, cout, style_dim, initial=i == 0, upsample=i > 0,
                            fused=i >= fused_from, generator=generator)
            for i, (cin, cout) in enumerate(G_LADDER)])
        self.to_rgb = nn.ModuleList([EqualConv2d(cout, 3, 1, generator=generator)
                                     for _, cout in G_LADDER])


class StyledGenerator(nn.Module):
    """The style MLP (``style``) and the progressive ``generator``."""

    def __init__(self, code_dim: int = 512, n_mlp: int = 8, fused_from: int = FUSED_FROM,
                 generator=None):
        super().__init__()
        self.code_dim = code_dim
        layers = [PixelNorm()]
        for _ in range(n_mlp):
            layers += [EqualLinear(code_dim, code_dim, generator), nn.LeakyReLU(0.2)]
        self.style = nn.Sequential(*layers)
        self.generator = Generator(code_dim, fused_from, generator)

    def style_forward(self, z):
        return self.style(z)

    def mean_style(self, n: int = 1024, generator=None):
        """The mean style of n draws of z ~ N(0, 1) [1, D] (truncation)."""
        z = torch.randn(n, self.code_dim, generator=generator,
                        device=next(self.parameters()).device)
        return self.style_forward(z).mean(0, keepdim=True)

    def make_noise(self, batch: int, step: int, generator=None, device=None):
        """Per-resolution noise [batch, 4 * 2^i, 4 * 2^i, 1], i = 0..step."""
        return [torch.randn(batch, 4 * 2 ** i, 4 * 2 ** i, 1, generator=generator,
                            device=device) for i in range(step + 1)]

    def forward(self, z, noise=None, step: int = 5, alpha: float = 1.0, generator=None,
                mean_style=None, style_weight: float = 0.0, inject_index=None,
                mixing_range=(-1, -1)):
        """z [B, D] or a list of them (style mixing) -> images [B, H, W, 3]
        f32, H = 4 * 2^step (step 5: 128 px, 8: 1024 px). noise: a list of
        step + 1 maps [B, h, h, 1], or None to draw them from ``generator``.
        mean_style + style_weight: truncation (model.py:494-503);
        inject_index: the crossover layers (the reference draws them with
        random.sample). Computed in the parameters' dtype. Under a row plan
        the blocks after the first whose output height qualifies run on this
        rank's rows, and the image is gathered whole."""
        zs = list(z) if isinstance(z, (list, tuple)) else [z]
        styles = [self.style_forward(s) for s in zs]
        b = zs[0].shape[0]
        if noise is None:
            noise = self.make_noise(b, step, generator, zs[0].device)
        if mean_style is not None:
            styles = [mean_style + style_weight * (s - mean_style) for s in styles]
        prog, to_rgb = self.generator.progression, self.generator.to_rgb
        inject = list(inject_index or [len(prog) + 1])
        out = out_prev = rows = None  # rows: the row plan, once out holds this rank's rows
        plan = hooks.row_plan()
        crossover = 0
        for i in range(step + 1):
            if tuple(mixing_range) == (-1, -1):
                if crossover < len(inject) and i > inject[crossover]:
                    crossover = min(crossover + 1, len(styles) - 1)
                style_step = styles[crossover]
            else:
                style_step = styles[1] if mixing_range[0] <= i <= mixing_range[1] else styles[0]
            if i > 0 and step > 0:
                out_prev = out
            nz = noise[i].permute(0, 3, 1, 2)
            out = prog[i](out, style_step, nz if rows is None else plan.constrain(nz, dim=2),
                          rows)
            if rows is None and plan is not None and plan.qualifies(out.shape[2]):
                out, rows = plan.constrain(out, dim=2), plan
                if out_prev is not None:  # the fade-in's skip, on this rank's rows too
                    out_prev = plan.constrain(out_prev, dim=2)
            if i == step:
                out = to_rgb[i](out)
                if i > 0 and 0 <= alpha < 1:
                    skip = F.interpolate(to_rgb[i - 1](out_prev), scale_factor=2, mode="nearest")
                    out = (1 - alpha) * skip + alpha * out
        if rows is not None:
            out = plan.boundary(out, dim=2)
        return out.permute(0, 2, 3, 1).float()
