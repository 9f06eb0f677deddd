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

Under a tp plan (models/hooks.py, parallel/tensor.py) each block's up-conv
runs on this rank's output channels and its partner conv on its input
channels, the latter as ``ops.styled_conv3x3_partial``, one all-reduce and
``ops.styled_conv3x3_epilogue``.

The discriminator runs its convs on cuDNN, its activations through
``ops.fused_leaky_relu`` and the blur before each stride-2 conv through
``ops.upfirdn2d``; a walk trains through all three backwards.

``synthesize(..., dtype=torch.bfloat16)`` and ``Discriminator.forward(...,
dtype=torch.bfloat16)`` (dtype None: the input's own, f32 or an f64
reference's) compute as the JAX package's ``dtype=`` does (its
--bf16): the tower casts its input, and each layer its f32 parameters, to
the activations' dtype per call (the parameters stay f32 masters, which
--updateGAN trains and the checkpoints hold); the modulation runs in bf16,
the demodulation in f32 from the bf16 ``s`` squared, cast to bf16; the
kernels take bf16 activations with f32 biases; the outputs are f32. The
style MLP stays f32.
"""

from __future__ import annotations

import logging
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import (blur2d, fused_leaky_relu, make_kernel, styled_conv3x3,
                   styled_conv3x3_epilogue, styled_conv3x3_partial, upsample2d)
from ..utils.remat import checkpoint
from . import hooks

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
        """In x's dtype; the weight is cast to it, the activation's bias
        stays f32 (the kernel's epilogue)."""
        out = x @ (self.weight * self.scale).t().to(x.dtype)
        if self.activation:
            return fused_leaky_relu(out, self.bias * self.lr_mul)
        return out + (self.bias * self.lr_mul).to(out.dtype)


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

    def sigma(self, s, weight):
        """The demodulation's sum scale^2 * sum_i s_i^2 * sum_k W[o, i, k]^2
        over the input channels of ``weight`` [Cout, Cin, k, k] (and of s):
        s squared in s's dtype, then the sums in the weight's (f32)."""
        w_sq = weight.square().sum((2, 3)).t()  # [Cin, Cout]
        return (self.scale * self.scale) * (s.square().to(w_sq.dtype) @ w_sq)

    def style_scales(self, style):
        """-> (s [B, Cin] in style's dtype, demod [B, Cout] or None)."""
        s = self.modulation(style)
        if not self.demodulate:
            return s, None
        return s, torch.rsqrt(self.sigma(s, self.weight[0]) + 1e-8)

    def hwio(self):
        """Scaled weight as [k, k, Cin, Cout], the kernel's layout."""
        return (self.weight[0] * self.scale).permute(2, 3, 1, 0).contiguous()

    def forward(self, x, style, halo: int = 0):
        """x [B, H, W, Cin] -> [B, H', W', Cout] (the up and 1x1 forms), in
        x's dtype. halo: x carries that many rows of its neighbours above and
        below its own (a row shard, parallel/spatial.py); the up form's blur
        crops what they add and returns the rows of x's own."""
        s, demod = self.style_scales(style)
        xs = x * s[:, None, None, :].to(x.dtype)
        w = (self.weight[0] * self.scale).to(x.dtype)  # [Cout, Cin, k, k]
        if self.upsample:
            # conv_transpose2d(stride 2, pad 0) on the unflipped weight is the
            # JAX lhs-dilated conv with flipped taps; output 2H+1, and the
            # blur with pad (1, 1) brings it to 2H
            out = F.conv_transpose2d(xs.permute(0, 3, 1, 2), w.transpose(0, 1),
                                     stride=2)
            p0, p1 = self.blur_pad
            out = blur2d(out.permute(0, 2, 3, 1).contiguous(), self.blur_kernel,
                         pad=(p0, p1, p0 - 2 * halo, p1 - 2 * halo), upsample_factor=2)
        elif w.shape[-1] == 1:
            out = xs @ w[:, :, 0, 0].t()
        else:
            raise NotImplementedError(
                "non-up k>1 modulated convs run as StyledConv's fused kernel"
            )
        if demod is not None:
            out = out * demod[:, None, None, :].to(out.dtype)
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
    # None (whole), or this rank's tensor-parallel part (parallel/tensor.py:
    # Shard, set by shard_generator): a "column" conv's weight and bias hold
    # output channels [lo, hi), a "row" conv's weight input channels [lo, hi)
    tp_shard = None

    def __init__(self, cin, cout, style_dim, upsample=False, generator=None):
        super().__init__()
        self.conv = ModulatedConv2d(cin, cout, 3, style_dim, upsample=upsample,
                                    generator=generator)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(cout)

    def forward(self, x, style, noise, halo: int = 0):
        """x [B, H, W, Cin]; noise [1|B, H', W'] (H' the output height); in
        x's dtype (noise_w and the bias stay f32 for the kernels). halo: x
        carries that many neighbour rows above and below its own (a row
        shard); the output holds the rows of x's own, and noise those.
        A tensor-parallel shard runs only under the tp plan: a "column"
        conv takes the whole x and returns this rank's output channels, a
        "row" conv takes this rank's input channels and returns the whole
        output (parallel/tensor.py)."""
        dt = x.dtype
        if self.tp_shard is not None:
            tp = hooks.tp_plan()
            if tp is None:
                raise RuntimeError("this conv holds one rank's tensor-parallel shard: run it "
                                   "under its tp plan (parallel/tensor.py:tensor_parallel)")
            if self.tp_shard.role == "row":
                return self._row_parallel(tp, x, style, noise)
            out = self.conv(tp.copy(x), tp.copy(style))
            out = out + self.noise.weight.to(dt) * noise.to(dt)[..., None]
            return fused_leaky_relu(out, self.activate.bias)
        if not self.conv.upsample:
            s, demod = self.conv.style_scales(style)
            if halo:  # the kernel pads by its own zero row: drop the halo's output rows
                noise = F.pad(noise, (0, 0, halo, halo))
            out = styled_conv3x3(x, self.conv.hwio().to(dt), s.to(dt), demod.to(dt),
                                 noise.to(dt), self.noise.weight, self.activate.bias)
            return out[:, halo:out.shape[1] - halo].contiguous() if halo else out
        out = self.conv(x, style, halo)
        out = out + self.noise.weight.to(dt) * noise.to(dt)[..., None]
        return fused_leaky_relu(out, self.activate.bias)

    def _row_parallel(self, tp, x, style, noise):
        """The partner conv on this rank's input channels: the partial
        product and the partial demodulation sums, summed over the model
        ranks in one all-reduce (f32), then the epilogue with d from the
        whole sum."""
        dt = x.dtype
        s = self.conv.modulation(tp.copy(style))[:, self.tp_shard.lo:self.tp_shard.hi]
        sigma = self.conv.sigma(s, self.conv.weight[0])
        acc = styled_conv3x3_partial(x, self.conv.hwio().to(dt), s.to(dt).contiguous())
        acc, sigma = tp.reduce(acc, sigma.to(acc.dtype))
        d = torch.rsqrt(sigma + 1e-8)
        return styled_conv3x3_epilogue(acc, d.to(dt), noise.to(dt), self.noise.weight,
                                       self.activate.bias)


class ToRGB(nn.Module):
    def __init__(self, cin, style_dim, generator=None):
        super().__init__()
        self.conv = ModulatedConv2d(cin, 3, 1, style_dim, demodulate=False,
                                    generator=generator)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))
        self.register_buffer("up_kernel", torch.from_numpy(make_kernel(BLUR_KERNEL)),
                             persistent=False)

    def forward(self, x, style, skip=None, halo: int = 0):
        """halo: skip carries that many neighbour rows above and below
        (a row shard), which its upsample crops."""
        out = self.conv(x, style) + self.bias.reshape(1, 1, 1, 3).to(x.dtype)
        if skip is not None:
            out = out + upsample2d(skip, self.up_kernel, halo=halo)
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
        # the stored noise maps are parameters, as in the JAX package's tree
        # (a G step trains them); a frozen G holds them without a gradient
        self.noises = nn.Module()
        for i, (h, w) in enumerate(noise_shapes(size)):
            self.noises.register_parameter(
                f"noise_{i}", nn.Parameter(_randn((1, 1, h, w), generator)))

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

    def _block_rows(self, j, x, skip, lat3, noise_a, noise_b):
        """Block j on this rank's rows (the installed row plan): each conv
        and the skip upsample take one halo row each side
        (parallel/spatial.py derives the widths); noise maps are sliced to
        the rank's output rows."""
        plan = hooks.row_plan()
        x = self.convs[2 * j](plan.halo(x), lat3[:, 0], plan.constrain(noise_a), halo=1)
        x = self.convs[2 * j + 1](plan.halo(x), lat3[:, 1], plan.constrain(noise_b),
                                  halo=1)
        return x, self.to_rgbs[j](x, lat3[:, 2], plan.halo(skip), halo=1)

    def synthesize(self, latent, noise=None, block_remat: bool = False,
                   dtype: torch.dtype | None = None):
        """latent [B, n_latent, D] -> image [B, size, size, 3] NHWC f32,
        computed in ``dtype`` (None: the latent's own; bf16 as the JAX
        package's --bf16: the latent and the constant input cast to it,
        every layer in it).

        noise: None uses the stored noise maps (randomize_noise=False); else a
        list of [1|B, h, w, 1] arrays per layer.

        block_remat: checkpoint each synthesis block (``torch.utils.
        checkpoint``, non-reentrant), as the JAX package's ``jax.checkpoint``
        per block: the backward recomputes one block at a time instead of
        keeping every block's activations. The noise comes in as an input,
        drawn before the region, so the recompute sees the same noise (a
        checkpoint restores the global RNG, not an explicit generator).

        Under a row plan (models/hooks.py, parallel/spatial.py) the blocks
        from the first that qualifies run on this rank's rows, and the rgb
        output is gathered whole on every rank."""
        if noise is None:
            noise = [getattr(self.noises, f"noise_{i}")[:, 0]
                     for i in range(num_noise_layers(self.size))]
        else:
            noise = [n.reshape(n.shape[:3]).contiguous() for n in noise]
        b = latent.shape[0]
        latent = latent if dtype is None else latent.to(dtype)
        x = self.input.input.to(latent.dtype).permute(0, 2, 3, 1).expand(b, -1, -1, -1)
        x = x.contiguous()
        x = self.conv1(x, latent[:, 0], noise[0])
        skip = self.to_rgb1(x, latent[:, 1])
        plan, block = hooks.row_plan(), self._block
        for j in range(len(self.to_rgbs)):
            if block == self._block and plan is not None and plan.shards_block(x.shape[1]):
                x, skip, block = hooks.spatial_constrain(x), hooks.spatial_constrain(skip), \
                    self._block_rows
            args = (j, x, skip, latent[:, 2 * j + 1:2 * j + 4], noise[2 * j + 1],
                    noise[2 * j + 2])
            x, skip = checkpoint(block, *args) if block_remat else block(*args)
        if block != self._block:
            skip = hooks.spatial_boundary(skip)
        return skip.float()

    def forward(self, styles, input_is_latent: bool = False,
                truncation: float = 1.0, truncation_latent=None, noise=None,
                noise_generator=None, block_remat: bool = False,
                dtype: torch.dtype | None = None):
        """styles: z [B, D] (mapped and broadcast over all layers) or W+
        [B, n_latent, D] when input_is_latent. noise_generator gives fresh
        noise when noise is None. block_remat checkpoints each synthesis
        block (``synthesize``), not the style MLP, as the JAX package's
        ``generator_forward``; so does ``dtype`` (the style MLP stays f32)."""
        if not input_is_latent:
            w = self.style_forward(styles)
            latent = w[:, None, :].expand(-1, self.n_latent, -1)
        else:
            latent = styles
        if truncation < 1.0:
            latent = truncation_latent + truncation * (latent - truncation_latent)
        if noise is None and noise_generator is not None:
            noise = self.make_noise(latent.shape[0], noise_generator)
        return self.synthesize(latent, noise=noise, block_remat=block_remat, dtype=dtype)


def generator_from_state_dict(sd, size: int) -> Generator:
    """A rosinality ``g_ema`` state_dict -> the Generator it was built as
    (style dim, MLP depth and channel table read from it), loaded with
    strict=True after its fixed blur kernels are stripped."""
    sd = strip_blur_kernels(sd)
    dim = int(sd["style.1.weight"].shape[1])
    n_mlp = sum(1 for k in sd if k.startswith("style.") and k.endswith(".weight"))
    g = Generator(size, dim, n_mlp, channels=channels_from_state_dict(sd, size))
    g.load_state_dict(sd, strict=True)
    return g


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
        dt = x.dtype
        out = F.conv2d(x.permute(0, 3, 1, 2), (self.weight * self.scale).to(dt),
                       None if self.bias is None else self.bias.to(dt),
                       stride=self.stride, padding=self.padding)
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
    the group size that is 1 and the channel is the constant sqrt(1e-8).

    In a data-parallel step (a gather installed in models/hooks.py) the
    statistic is taken over the global batch, whose groups (samples i,
    i + B/g, ...) span ranks as in the JAX step, and each rank keeps its
    rows; the gather's backward carries every rank's loss to these rows."""
    local = x
    gather = hooks.batch_gather()
    if gather is not None:  # a data-parallel step: the statistic of the global batch
        x, lo = gather(x)
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
    if gather is not None:
        stat = stat[lo:lo + local.shape[0]]
    return torch.cat([local, stat.to(local.dtype)], dim=-1)


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

    def forward(self, img, dtype: torch.dtype | None = None):
        """Computed in ``dtype`` (the image cast to it, as the JAX
        package's ``discriminator_forward``; None: the image's own); the
        logits are f32."""
        x = img if dtype is None else img.to(dtype)
        x = self.final_conv(minibatch_stddev(self.convs(x)))
        # the reference flattens NCHW, in (c, h, w) order
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
        return self.final_linear(x).float()


def strip_blur_kernels(sd) -> dict:
    """A rosinality state_dict without its fixed FIR ``.kernel`` buffers."""
    return {k: v for k, v in sd.items() if not k.endswith(".kernel")}
