"""StyleGAN2 generator and discriminator (rosinality layout), PyTorch port.

The counterpart of latent2im_tpu/models/stylegan2.py. Parameter names follow
the rosinality ``g_ema`` and ``d`` state_dicts (``style.N.weight``,
``convs.N.conv.modulation.bias``, ``noises.noise_N``; ``convs.0.0.weight``,
``convs.N.conv2.1.weight``, ``final_linear.0.bias``, ...), so
``tests/fixtures/ref_g_tiny.pt`` and reference checkpoints load with
``load_state_dict`` and no conversion (the fixed blur ``.kernel`` buffers of
the reference are rebuilt here and dropped from a checkpoint first). Weights are stored in equalized-LR raw
form (linear weights ~N(0,1)/lr_mul, runtime scale lr_mul/sqrt(fan_in)).

Public tensors are NHWC, as in the JAX package. A modulated conv is computed
as one conv shared by the batch: modulation scales the input channels and
demodulation the output channels,

    demod[b, o] = rsqrt(scale^2 * sum_i s[b, i]^2 * sum_k W[o, i, k]^2 + 1e-8),

so no per-sample weight tensor is made. Every non-up 3x3 styled conv runs the
fused kernel ``ops.styled_conv3x3``; the up convs run a transposed conv, the
``ops.upfirdn2d`` blur and ``ops.fused_leaky_relu``; the skip upsample in
``ToRGB`` runs ``ops.upfirdn2d`` at C=3 (the JAX package's polyphase shift
form at >=128 px, ``SKIP_SHIFT_MIN_RES``, computes the same function, as its
space-to-depth FAST_TAIL does for the 1024 px model's thin 512/1024 px
blocks). ``synthesize(..., block_remat=True)`` checkpoints each block.

The discriminator runs its convs on cuDNN, its activations through
``ops.fused_leaky_relu`` and the blur before each stride-2 conv through
``ops.upfirdn2d``; a walk trains through all three backwards.
"""

from __future__ import annotations

import logging
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import (blur2d, fused_leaky_relu, make_kernel, styled_conv3x3,
                   upsample2d)
from ..utils.remat import checkpoint

BLUR_KERNEL = (1, 3, 3, 1)


def channel_table(channel_multiplier: int = 2) -> dict[int, int]:
    return {
        4: 512, 8: 512, 16: 512, 32: 512,
        64: 256 * channel_multiplier,
        128: 128 * channel_multiplier,
        256: 64 * channel_multiplier,
        512: 32 * channel_multiplier,
        1024: 16 * channel_multiplier,
    }


def n_latent(size: int) -> int:
    return int(math.log2(size)) * 2 - 2


def num_noise_layers(size: int) -> int:
    return (int(math.log2(size)) - 2) * 2 + 1


def noise_shapes(size: int) -> list[tuple[int, int]]:
    return [(2 ** ((i + 5) // 2),) * 2 for i in range(num_noise_layers(size))]


def pixel_norm(x, eps: float = 1e-8):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)


def _randn(shape, generator):
    return torch.randn(shape, generator=generator)


class EqualLinear(nn.Module):
    def __init__(self, in_dim, out_dim, bias_init=0.0, lr_mul=1.0,
                 activation=False, generator=None):
        super().__init__()
        self.weight = nn.Parameter(_randn((out_dim, in_dim), generator) / lr_mul)
        self.bias = nn.Parameter(torch.full((out_dim,), float(bias_init)))
        self.scale = lr_mul / math.sqrt(in_dim)
        self.lr_mul = lr_mul
        self.activation = activation

    def forward(self, x):
        out = x @ (self.weight * self.scale).t()
        if self.activation:
            return fused_leaky_relu(out, self.bias * self.lr_mul)
        return out + self.bias * self.lr_mul


class ModulatedConv2d(nn.Module):
    """Style-modulated conv (weight [1, Cout, Cin, k, k])."""

    def __init__(self, cin, cout, k, style_dim, demodulate=True,
                 upsample=False, generator=None):
        super().__init__()
        self.weight = nn.Parameter(_randn((1, cout, cin, k, k), generator))
        self.modulation = EqualLinear(style_dim, cin, bias_init=1.0,
                                      generator=generator)
        self.scale = 1.0 / math.sqrt(cin * k * k)
        self.demodulate = demodulate
        self.upsample = upsample
        if upsample:
            self.register_buffer("blur_kernel", torch.from_numpy(make_kernel(BLUR_KERNEL)),
                                 persistent=False)
            p = len(BLUR_KERNEL) - 2 - (k - 1)
            self.blur_pad = ((p + 1) // 2 + 1, p // 2 + 1)

    def style_scales(self, style):
        """-> (s [B, Cin], demod [B, Cout] or None)."""
        s = self.modulation(style)
        if not self.demodulate:
            return s, None
        w_sq = self.weight[0].square().sum((2, 3)).t()  # [Cin, Cout]
        return s, torch.rsqrt((self.scale * self.scale) * (s.square() @ w_sq) + 1e-8)

    def hwio(self):
        """Scaled weight as [k, k, Cin, Cout], the kernel's layout."""
        return (self.weight[0] * self.scale).permute(2, 3, 1, 0).contiguous()

    def forward(self, x, style):
        """x [B, H, W, Cin] -> [B, H', W', Cout] (the up and 1x1 forms)."""
        s, demod = self.style_scales(style)
        xs = x * s[:, None, None, :]
        w = self.weight[0] * self.scale  # [Cout, Cin, k, k]
        if self.upsample:
            # conv_transpose2d(stride 2, pad 0) on the unflipped weight is the
            # JAX lhs-dilated conv with flipped taps; output 2H+1, and the
            # blur with pad (1, 1) brings it to 2H
            out = F.conv_transpose2d(xs.permute(0, 3, 1, 2), w.transpose(0, 1),
                                     stride=2)
            out = blur2d(out.permute(0, 2, 3, 1).contiguous(), self.blur_kernel,
                         pad=self.blur_pad, upsample_factor=2)
        elif w.shape[-1] == 1:
            out = xs @ w[:, :, 0, 0].t()
        else:
            raise NotImplementedError(
                "non-up k>1 modulated convs run as StyledConv's fused kernel"
            )
        if demod is not None:
            out = out * demod[:, None, None, :]
        return out


class NoiseInjection(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))


class FusedLeakyReLU(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return fused_leaky_relu(x, self.bias)


class StyledConv(nn.Module):
    def __init__(self, cin, cout, style_dim, upsample=False, generator=None):
        super().__init__()
        self.conv = ModulatedConv2d(cin, cout, 3, style_dim, upsample=upsample,
                                    generator=generator)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(cout)

    def forward(self, x, style, noise):
        """x [B, H, W, Cin]; noise [1|B, H', W'] (H' the output height)."""
        if not self.conv.upsample:
            s, demod = self.conv.style_scales(style)
            return styled_conv3x3(x, self.conv.hwio(), s, demod, noise,
                                  self.noise.weight, self.activate.bias)
        out = self.conv(x, style)
        out = out + self.noise.weight * noise[..., None]
        return fused_leaky_relu(out, self.activate.bias)


class ToRGB(nn.Module):
    def __init__(self, cin, style_dim, generator=None):
        super().__init__()
        self.conv = ModulatedConv2d(cin, 3, 1, style_dim, demodulate=False,
                                    generator=generator)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))
        self.register_buffer("up_kernel", torch.from_numpy(make_kernel(BLUR_KERNEL)),
                             persistent=False)

    def forward(self, x, style, skip=None):
        out = self.conv(x, style) + self.bias.reshape(1, 1, 1, 3)
        if skip is not None:
            out = out + upsample2d(skip, self.up_kernel)
        return out


class ConstantInput(nn.Module):
    def __init__(self, channels, generator=None):
        super().__init__()
        self.input = nn.Parameter(_randn((1, channels, 4, 4), generator))


class Generator(nn.Module):
    """StyleGAN2 generator. ``generator`` (a CPU ``torch.Generator``) seeds
    the random init, with the JAX package's distributions."""

    def __init__(self, size: int, style_dim: int = 512, n_mlp: int = 8,
                 channel_multiplier: int = 2,
                 channels: dict[int, int] | None = None, generator=None):
        super().__init__()
        channels = channels or channel_table(channel_multiplier)
        self.size, self.style_dim = size, style_dim
        self.log_size = int(math.log2(size))
        self.n_latent = n_latent(size)
        # style.0 is the (parameter-free) PixelNorm of the reference Sequential
        self.style = nn.ModuleDict({
            str(i + 1): EqualLinear(style_dim, style_dim, lr_mul=0.01,
                                    activation=True, generator=generator)
            for i in range(n_mlp)
        })
        self.input = ConstantInput(channels[4], generator=generator)
        self.conv1 = StyledConv(channels[4], channels[4], style_dim,
                                generator=generator)
        self.to_rgb1 = ToRGB(channels[4], style_dim, generator=generator)
        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        cin = channels[4]
        for i in range(3, self.log_size + 1):
            cout = channels[2 ** i]
            self.convs.append(StyledConv(cin, cout, style_dim, upsample=True,
                                         generator=generator))
            self.convs.append(StyledConv(cout, cout, style_dim,
                                         generator=generator))
            self.to_rgbs.append(ToRGB(cout, style_dim, generator=generator))
            cin = cout
        self.noises = nn.Module()
        for i, (h, w) in enumerate(noise_shapes(size)):
            self.noises.register_buffer(f"noise_{i}", _randn((1, 1, h, w), generator))

    def style_forward(self, z):
        """The mapping network z [B, D] -> w [B, D]."""
        x = pixel_norm(z)
        for i in range(len(self.style)):
            x = self.style[str(i + 1)](x)
        return x

    def mean_latent(self, n: int = 4096, generator=None):
        z = torch.randn((n, self.style_dim), generator=generator,
                        device=self.input.input.device)
        return self.style_forward(z).mean(0, keepdim=True)

    def make_noise(self, batch: int, generator=None):
        """Fresh per-layer noise [batch, h, w, 1] (randomize_noise=True)."""
        dev = self.input.input.device
        return [torch.randn((batch, h, w, 1), generator=generator, device=dev)
                for (h, w) in noise_shapes(self.size)]

    def _block(self, j, x, skip, lat3, noise_a, noise_b):
        """Synthesis block j: the up styled conv, the styled conv and to_rgb
        of one resolution."""
        x = self.convs[2 * j](x, lat3[:, 0], noise_a)
        x = self.convs[2 * j + 1](x, lat3[:, 1], noise_b)
        return x, self.to_rgbs[j](x, lat3[:, 2], skip)

    def synthesize(self, latent, noise=None, block_remat: bool = False):
        """latent [B, n_latent, D] -> image [B, size, size, 3] NHWC f32.

        noise: None uses the stored buffers (randomize_noise=False); else a
        list of [1|B, h, w, 1] arrays per layer.

        block_remat: checkpoint each synthesis block (``torch.utils.
        checkpoint``, non-reentrant), as the JAX package's ``jax.checkpoint``
        per block: the backward recomputes one block at a time instead of
        keeping every block's activations. The noise comes in as an input,
        drawn before the region, so the recompute sees the same noise (a
        checkpoint restores the global RNG, not an explicit generator)."""
        if noise is None:
            noise = [getattr(self.noises, f"noise_{i}")[:, 0]
                     for i in range(num_noise_layers(self.size))]
        else:
            noise = [n.reshape(n.shape[:3]).contiguous() for n in noise]
        b = latent.shape[0]
        x = self.input.input.permute(0, 2, 3, 1).expand(b, -1, -1, -1).contiguous()
        x = self.conv1(x, latent[:, 0], noise[0])
        skip = self.to_rgb1(x, latent[:, 1])
        for j in range(len(self.to_rgbs)):
            args = (j, x, skip, latent[:, 2 * j + 1:2 * j + 4], noise[2 * j + 1],
                    noise[2 * j + 2])
            x, skip = checkpoint(self._block, *args) if block_remat else self._block(*args)
        return skip.float()

    def forward(self, styles, input_is_latent: bool = False,
                truncation: float = 1.0, truncation_latent=None, noise=None,
                noise_generator=None):
        """styles: z [B, D] (mapped and broadcast over all layers) or W+
        [B, n_latent, D] when input_is_latent. noise_generator gives fresh
        noise when noise is None."""
        if not input_is_latent:
            w = self.style_forward(styles)
            latent = w[:, None, :].expand(-1, self.n_latent, -1)
        else:
            latent = styles
        if truncation < 1.0:
            latent = truncation_latent + truncation * (latent - truncation_latent)
        if noise is None and noise_generator is not None:
            noise = self.make_noise(latent.shape[0], noise_generator)
        return self.synthesize(latent, noise=noise)


def channels_from_state_dict(sd, size: int) -> dict[int, int]:
    """The channel table a rosinality g_ema state_dict was built with."""
    ch = {4: int(sd["input.input"].shape[1])}
    for j in range(int(math.log2(size)) - 2):
        ch[2 ** (j + 3)] = int(sd[f"convs.{2 * j}.conv.weight"].shape[1])
    return ch


# ---------------------------------------------------------------------------
# discriminator (JAX models/stylegan2.py:614-722)
# ---------------------------------------------------------------------------


class EqualConv2d(nn.Module):
    """Equalized-LR conv, NHWC in and out (cuDNN on channels_last memory)."""

    def __init__(self, cin, cout, k, stride=1, padding=0, bias=True,
                 generator=None):
        super().__init__()
        self.weight = nn.Parameter(_randn((cout, cin, k, k), generator))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.scale = 1.0 / math.sqrt(cin * k * k)
        self.stride, self.padding = stride, padding

    def forward(self, x):
        out = F.conv2d(x.permute(0, 3, 1, 2), self.weight * self.scale,
                       self.bias, stride=self.stride, padding=self.padding)
        return out.permute(0, 2, 3, 1).contiguous()


class Blur(nn.Module):
    def __init__(self, pad):
        super().__init__()
        self.register_buffer("kernel", torch.from_numpy(make_kernel(BLUR_KERNEL)),
                             persistent=False)
        self.pad = pad

    def forward(self, x):
        return blur2d(x, self.kernel, pad=self.pad)


class ConvLayer(nn.Sequential):
    """[Blur if downsample] -> EqualConv2d -> [FusedLeakyReLU if activate],
    indexed as the reference's Sequential (``conv2.1.weight``)."""

    def __init__(self, cin, cout, k, downsample=False, bias=True,
                 activate=True, generator=None):
        layers = []
        if downsample:
            p = (len(BLUR_KERNEL) - 2) + (k - 1)
            layers.append(Blur(((p + 1) // 2, p // 2)))
            stride, padding = 2, 0
        else:
            stride, padding = 1, k // 2
        layers.append(EqualConv2d(cin, cout, k, stride, padding,
                                  bias=bias and not activate,
                                  generator=generator))
        if activate:  # every activated conv of D has a bias
            layers.append(FusedLeakyReLU(cout))
        super().__init__(*layers)


class ResBlock(nn.Module):
    def __init__(self, cin, cout, generator=None):
        super().__init__()
        self.conv1 = ConvLayer(cin, cin, 3, generator=generator)
        self.conv2 = ConvLayer(cin, cout, 3, downsample=True, generator=generator)
        self.skip = ConvLayer(cin, cout, 1, downsample=True, bias=False,
                              activate=False, generator=generator)

    def forward(self, x):
        return (self.conv2(self.conv1(x)) + self.skip(x)) / math.sqrt(2)


def minibatch_stddev(x, group_size: int = 4):
    """Minibatch stddev channel over NHWC x -> [B, H, W, C+1].

    The group falls back to the largest divisor of the batch <= group_size
    (the reference's view needs batch % group == 0); at a prime batch above
    the group size that is 1 and the channel is the constant sqrt(1e-8)."""
    b, h, w, c = x.shape
    g = min(b, group_size)
    while b % g:
        g -= 1
    if g == 1 and b > 1 and not getattr(minibatch_stddev, "_warned_g1", False):
        minibatch_stddev._warned_g1 = True
        logging.getLogger(__name__).warning(
            "minibatch_stddev: batch %d has no divisor <= group_size %d; "
            "group=1 makes the stddev channel constant", b, group_size)
    y = x.reshape(g, b // g, h, w, c)
    std = torch.sqrt(y.var(0, unbiased=False) + 1e-8)
    stat = std.mean((1, 2, 3)).reshape(b // g, 1, 1, 1).repeat(g, h, w, 1)
    return torch.cat([x, stat.to(x.dtype)], dim=-1)


class Discriminator(nn.Module):
    """StyleGAN2 discriminator: image NHWC [B, size, size, 3] -> logits
    [B, 1] f32."""

    def __init__(self, size: int, channel_multiplier: int = 2,
                 channels: dict[int, int] | None = None, generator=None):
        super().__init__()
        channels = channels or channel_table(channel_multiplier)
        convs = [ConvLayer(3, channels[size], 1, generator=generator)]
        cin = channels[size]
        for i in range(int(math.log2(size)), 2, -1):
            cout = channels[2 ** (i - 1)]
            convs.append(ResBlock(cin, cout, generator=generator))
            cin = cout
        self.convs = nn.Sequential(*convs)
        self.final_conv = ConvLayer(cin + 1, channels[4], 3, generator=generator)
        self.final_linear = nn.Sequential(
            EqualLinear(channels[4] * 16, channels[4], activation=True,
                        generator=generator),
            EqualLinear(channels[4], 1, generator=generator),
        )

    def forward(self, img):
        x = self.final_conv(minibatch_stddev(self.convs(img)))
        # the reference flattens NCHW, in (c, h, w) order
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
        return self.final_linear(x).float()


def strip_blur_kernels(sd) -> dict:
    """A rosinality state_dict without its fixed FIR ``.kernel`` buffers."""
    return {k: v for k, v in sd.items() if not k.endswith(".kernel")}
