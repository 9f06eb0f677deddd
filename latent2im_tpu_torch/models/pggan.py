"""Progressive GAN of the reference's graphs/pggan/model_256.py — PyTorch
port of latent2im_tpu/models/pggan.py.

Generator: pixel norm on z (concatenated with a label embedding when the
model has one), a 9-block progressive ladder (4x4 ... 1024x1024, channels
512 ... 16), a 1x1 ``to_rgb`` per resolution and the step/alpha fade-in.
Discriminator: the mirrored ladder with a 1x1 ``from_rgb`` per resolution,
2x2 average pooling, the batch-std channel and a (score, label logits)
head.

Parameter names are the reference's, so its checkpoints load with
``load_state_dict(strict=True)``: ``progression.{i}.conv.{0,3}.conv.
weight_orig`` and ``.bias`` (G; D at ``.{0,2}``), ``to_rgb.{i}``,
``label_embed.weight``, ``from_rgb.{i}`` and ``linear``. An equalized-LR
conv stores its raw N(0, 1) weight as ``weight_orig`` and applies
sqrt(2 / fan_in) at run time; ``to_rgb``/``from_rgb`` are plain convs. A G
block is conv -> pixel norm -> LeakyReLU(0.2), twice; D's blocks have no
pixel norm; the stem pads 3 and D's last block ends in a 4x4 valid conv
(the JAX package's ``block_pads``).

Public tensors are NHWC, as in the JAX package; the models compute in NCHW
with ``F.conv2d`` (cuDNN on the card): no hand-written kernel runs here,
since none of the JAX package's PGGAN computation is a Pallas kernel. The
equalized convs run as one GEMM over their unfolded patches (``conv2d``):
cuDNN's f32 heuristics (TF32 off) send the G's 256 -> 128 conv at 128 px
to an FFT algorithm of some 33000 small complex GEMMs, ~275 ms at B=4 with
an 18 GB workspace on an H100, where the GEMM takes 1.3 ms
(scripts/torch_pggan_profile.py, PERF.md); which shapes its heuristics
send there is not observable from PyTorch, so no conv of these models
goes to cuDNN but the 1x1 rgb heads.

``dtype=torch.bfloat16`` (G and D) computes as the JAX package's
``dtype=``: z or the image cast to bf16, each layer's f32 parameters cast
per call (the GEMMs over unfolded patches become bf16 GEMMs), f32 outputs.

Under a row plan (models/hooks.py, parallel/spatial.py) G runs on this
rank's image rows from the first block whose output height qualifies (the
JAX package's hook after each block, models/pggan.py:203-225 there): the
nearest x2 upsampling, the pixel norm, LeakyReLU and the 1x1 rgb heads are
row-local, each 3x3 pad-1 conv takes one halo row each side, and the rgb
output is gathered whole.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import hooks

N_LABEL = 10
CODE_DIM = 512 - N_LABEL

# (in_ch, out_ch) per progression block; block 0 is the 4x4 stem
G_LADDER = [
    (512, 512), (512, 512), (512, 512), (512, 512),
    (512, 256), (256, 128), (128, 64), (64, 32), (32, 16),
]
# D's ladder runs the reverse; its last block takes the +1 std channel
D_LADDER = [
    (16, 32), (32, 64), (64, 128), (128, 256), (256, 512),
    (512, 512), (512, 512), (512, 512), (512, 512), (513, 512),
]
D_FROM_RGB = [16, 32, 64, 128, 256, 512, 512, 512, 512, 512]


def step_to_resolution(step: int) -> int:
    return 4 * (2 ** step)


def pixel_norm(x, dim: int = 1, eps: float = 1e-8):
    return x / torch.sqrt(torch.mean(x * x, dim=dim, keepdim=True) + eps)


def conv2d(x, w, b, padding):
    """F.conv2d(x, w, b, padding=padding) on NCHW, computed as one batched
    GEMM of the weight [Cout, Cin * kh * kw] over ``F.unfold``'s patches
    (the same sums; autograd differentiates unfold and the GEMM), in x's
    dtype (w and b cast to it). padding: an int, or (rows, columns)."""
    w, b = w.to(x.dtype), None if b is None else b.to(x.dtype)
    kh, kw = w.shape[2:]
    ph, pw = (padding, padding) if isinstance(padding, int) else padding
    h, wd = x.shape[2] + 2 * ph - kh + 1, x.shape[3] + 2 * pw - kw + 1
    cols = F.unfold(x, (kh, kw), padding=(ph, pw))  # [B, Cin * kh * kw, h * wd]
    out = torch.matmul(w.reshape(w.shape[0], -1), cols)
    if b is not None:
        out = out + b[:, None]
    return out.reshape(x.shape[0], w.shape[0], h, wd)


def _uniform(shape, bound, generator):
    return (torch.rand(shape, generator=generator) * 2 - 1) * bound


class _EqualConvParams(nn.Module):
    """The reference's equal_lr-wrapped ``nn.Conv2d``: ``weight_orig`` ~ N(0, 1),
    ``bias`` 0."""

    def __init__(self, cin, cout, k, generator=None):
        super().__init__()
        self.weight_orig = nn.Parameter(torch.randn((cout, cin, k, k), generator=generator))
        self.bias = nn.Parameter(torch.zeros(cout))


class EqualConv2d(nn.Module):
    def __init__(self, cin, cout, k, padding, generator=None):
        super().__init__()
        self.conv = _EqualConvParams(cin, cout, k, generator)
        self.padding = padding
        self.scale = math.sqrt(2.0 / (cin * k * k))

    def forward(self, x, plan=None):
        """plan: x holds this rank's rows of the image (a row plan): the
        conv takes ``padding`` halo rows each side and pads only the
        columns."""
        w = self.conv.weight_orig * self.scale
        if plan is None:
            return conv2d(x, w, self.conv.bias, self.padding)
        return conv2d(plan.halo(x, self.padding, dim=2), w, self.conv.bias, (0, self.padding))


def _rgb(conv, x):
    """A 1x1 rgb head (``nn.Conv2d``) in x's dtype."""
    return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype))


def _plain_conv(cin, cout, generator=None):
    """A 1x1 ``nn.Conv2d`` with torch's default init, U(+-1/sqrt(fan_in))."""
    conv = nn.Conv2d(cin, cout, 1)
    bound = 1.0 / math.sqrt(cin)
    with torch.no_grad():
        conv.weight.copy_(_uniform(conv.weight.shape, bound, generator))
        conv.bias.copy_(_uniform(conv.bias.shape, bound, generator))
    return conv


class PixelNorm(nn.Module):
    def forward(self, x):
        return pixel_norm(x)


class ConvBlock(nn.Module):
    """Two equalized convs, each followed (in G) by pixel norm, and by
    LeakyReLU(0.2)."""

    def __init__(self, cin, cout, k1, p1, k2, p2, norm: bool, generator=None):
        super().__init__()

        def tail():
            return [PixelNorm(), nn.LeakyReLU(0.2)] if norm else [nn.LeakyReLU(0.2)]

        self.conv = nn.Sequential(EqualConv2d(cin, cout, k1, p1, generator), *tail(),
                                  EqualConv2d(cout, cout, k2, p2, generator), *tail())

    def forward(self, x, plan=None):
        """plan: x holds this rank's rows (the convs take halo rows)."""
        for layer in self.conv:
            x = layer(x, plan) if isinstance(layer, EqualConv2d) else layer(x)
        return x


def _upsample_nearest(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Generator(nn.Module):
    """model_256's generator. n_label=10 is model_256.py's (a 502-d code
    plus a 10-d label embedding make 512); n_label=0 is a plain 512-d z, the
    shape the reference runs. ``generator`` (a CPU ``torch.Generator``)
    seeds the init, with the JAX package's distributions."""

    def __init__(self, n_label: int = N_LABEL, generator=None):
        super().__init__()
        if n_label > 0:
            self.label_embed = nn.Embedding(n_label, n_label)
            with torch.no_grad():
                self.label_embed.weight.copy_(torch.randn((n_label, n_label),
                                                          generator=generator))
        self.progression = nn.ModuleList()
        self.to_rgb = nn.ModuleList()
        for i, (cin, cout) in enumerate(G_LADDER):
            k1, p1 = (4, 3) if i == 0 else (3, 1)
            self.progression.append(ConvBlock(cin, cout, k1, p1, 3, 1, True, generator))
            self.to_rgb.append(_plain_conv(cout, 3, generator))

    @classmethod
    def from_state_dict(cls, sd) -> "Generator":
        """A reference state_dict (``module.`` prefixes stripped) -> the
        generator, with or without its label embedding, loaded strict."""
        sd = strip_module_prefix(sd)
        n_label = int(sd["label_embed.weight"].shape[0]) if "label_embed.weight" in sd else 0
        g = cls(n_label=n_label)
        load_strict(g, sd)
        return g

    def forward(self, z, step: int = 6, alpha: float = 0.0, label=None,
                dtype: torch.dtype | None = None):
        """z [B, 512 - n_label] -> image [B, R, R, 3] NHWC f32, R = 4 *
        2**step, computed in ``dtype`` (None: z's own).

        label: int64 [B], zeros by default (model_256.py:232). The default
        alpha=0 is the reference's call sites' (netG(z) bare), whose blend
        outputs the PREVIOUS resolution's rgb head on the upsampled features;
        alpha outside [0, 1) turns the blend off. Under a row plan the blocks
        after the first whose output height qualifies run on this rank's
        rows, and the image is gathered whole."""
        b = z.shape[0]
        x = pixel_norm(z if dtype is None else z.to(dtype), dim=-1)
        if hasattr(self, "label_embed"):
            if label is None:
                label = torch.zeros((b,), dtype=torch.long, device=z.device)
            x = torch.cat([x, self.label_embed.weight[label].to(x.dtype)], dim=-1)
        cin = self.progression[0].conv[0].conv.weight_orig.shape[1]
        if x.shape[-1] != cin:
            # where the JAX package's conv raises a ValueError on these shapes
            raise ValueError(f"the PGGAN stem takes {cin} channels; z of width "
                            f"{z.shape[-1]} gives {x.shape[-1]}")
        out = x[:, :, None, None]
        upsample = rows = None  # rows: the row plan, once out holds this rank's rows
        plan = hooks.row_plan()
        for i in range(step + 1):
            if i > 0 and step > 0:
                upsample = _upsample_nearest(out)
                out = self.progression[i](upsample, rows)
            else:
                out = self.progression[i](out, rows)
            if rows is None and plan is not None and plan.qualifies(out.shape[2]):
                out, rows = plan.constrain(out, dim=2), plan
            if i == step:
                out = _rgb(self.to_rgb[i], out)
                if i > 0 and 0 <= alpha < 1:
                    if rows is not None and upsample.shape[2] != out.shape[2]:
                        upsample = plan.constrain(upsample, dim=2)  # sharded at this block
                    out = (1 - alpha) * _rgb(self.to_rgb[i - 1], upsample) + alpha * out
        if rows is not None:
            out = plan.boundary(out, dim=2)
        return out.permute(0, 2, 3, 1).float()


class Discriminator(nn.Module):
    def __init__(self, n_label: int = N_LABEL, generator=None):
        super().__init__()
        self.progression = nn.ModuleList()
        self.from_rgb = nn.ModuleList()
        last = len(D_LADDER) - 1
        for i, (cin, cout) in enumerate(D_LADDER):
            k2, p2 = (4, 0) if i == last else (3, 1)
            self.progression.append(ConvBlock(cin, cout, 3, 1, k2, p2, False, generator))
            self.from_rgb.append(_plain_conv(3, D_FROM_RGB[i], generator))
        self.linear = nn.Linear(512, 1 + n_label)
        bound = 1.0 / math.sqrt(512)
        with torch.no_grad():
            self.linear.weight.copy_(_uniform(self.linear.weight.shape, bound, generator))
            self.linear.bias.copy_(_uniform(self.linear.bias.shape, bound, generator))

    @classmethod
    def from_state_dict(cls, sd) -> "Discriminator":
        sd = strip_module_prefix(sd)
        d = cls(n_label=int(sd["linear.weight"].shape[0]) - 1)
        load_strict(d, sd)
        return d

    def forward(self, img, step: int = 6, alpha: float = 0.0,
                dtype: torch.dtype | None = None):
        """img [B, R, R, 3] NHWC, R = 4 * 2**step -> (score [B], label
        logits [B, n_label]) f32 (model_256.py:329-353), computed in
        ``dtype`` (None: the image's own). The batch-std channel
        is the unbiased std over the batch of the input image, averaged. At
        the default alpha=0 the blend at the input resolution keeps only the
        skip path, though both are computed, as in the JAX package."""
        x = (img if dtype is None else img.to(dtype)).permute(0, 3, 1, 2)
        n_layer = len(self.progression)
        out = None
        for i in range(step, -1, -1):
            index = n_layer - i - 1
            if i == step:
                out = _rgb(self.from_rgb[index], x)
            if i == 0:
                mean_std = torch.std(x, dim=0, unbiased=True).mean()
                out = torch.cat([out, mean_std.expand(out.shape[0], 1, *out.shape[2:])], 1)
            out = self.progression[index](out)
            if i > 0:
                out = F.avg_pool2d(out, 2)
                if i == step and 0 <= alpha < 1:
                    skip = _rgb(self.from_rgb[index + 1], F.avg_pool2d(x, 2))
                    out = (1 - alpha) * skip + alpha * out
        out = out.permute(0, 2, 3, 1).reshape(out.shape[0], -1)
        if out.shape[1] != self.linear.in_features:
            # where the JAX package's matmul raises a TypeError on these shapes
            raise TypeError(f"D at step {step} flattens {out.shape[1]} features for a "
                            f"{img.shape[1]} px image; its head takes "
                            f"{self.linear.in_features} (the image size does not fit "
                            "the step)")
        out = F.linear(out, self.linear.weight.to(x.dtype), self.linear.bias.to(x.dtype))
        return out[:, 0].float(), out[:, 1:].float()


def strip_module_prefix(sd) -> dict:
    """DataParallel checkpoints carry ``module.`` prefixes
    (pggan transform_base.py:568-597)."""
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def load_strict(module: nn.Module, sd) -> None:
    """load_state_dict(strict=True), raising KeyError on the first missing
    key, as the JAX package's converters do."""
    missing = [k for k in module.state_dict() if k not in sd]
    if missing:
        raise KeyError(missing[0])
    module.load_state_dict(sd, strict=True)
