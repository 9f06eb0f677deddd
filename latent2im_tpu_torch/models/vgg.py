"""VGG16/VGG19 feature towers for the perceptual losses, PyTorch port.

The counterpart of latent2im_tpu/models/vgg.py: torchvision's
``vgg16().features`` and ``vgg19().features`` as one tap-emitting forward.
VGG19's taps ``conv_1`` .. ``conv_4`` give the walk-training content loss,
with ImageNet normalization applied to the generator's [-1, 1] output as it
is, without a rescale to [0, 1] (a quirk of the reference, kept); VGG16's
``relu_2/4/7/10`` give W+ inversion's gram loss (``gram_matrix``).
Parameter names are torchvision's (``features.N.weight``), and the whole
conv stack is held, so a torchvision state_dict loads with ``strict=True``;
the forward stops at the last tap it is asked for. Written by hand, since
the port may not depend on torchvision. ``forward(..., dtype=)`` runs the
stack in bf16 as the JAX package's ``vgg_features(..., dtype=)`` does (the
input and each conv's f32 weight and bias cast per call).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

CFG16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
         512, 512, 512, "M")
CFG19 = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512,
         512, "M", 512, 512, 512, 512, "M")
CFGS = {"vgg16": CFG16, "vgg19": CFG19}
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# walk-training content-loss taps (the reference's transform_base.py:427)
CONTENT_TAPS = ("conv_1", "conv_2", "conv_3", "conv_4")
# the inversion's vgg16 gram taps, relu1_2/2_2/3_3/4_3 (the reference's
# perceptual_vgg/vgg.py:14-21)
VGG16_GRAM_TAPS = ("relu_2", "relu_4", "relu_7", "relu_10")


def imagenet_normalize(img):
    """(img - mean) / std over the last (channel) axis of NHWC images."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=img.dtype, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=img.dtype, device=img.device)
    return (img - mean) / std


class VGGFeatures(nn.Module):
    """torchvision ``vgg16().features`` or ``vgg19().features``;
    ``generator`` seeds the JAX package's init (uniform +-1/sqrt(fan_in)
    weights, zero bias)."""

    def __init__(self, cfg_name: str = "vgg19", generator=None):
        super().__init__()
        layers: list[nn.Module] = []
        cin = 3
        for v in CFGS[cfg_name]:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
                continue
            conv = nn.Conv2d(cin, v, 3, padding=1)
            bound = 1.0 / math.sqrt(cin * 9)
            with torch.no_grad():
                conv.weight.copy_(
                    torch.rand(conv.weight.shape, generator=generator) * 2 * bound - bound)
                conv.bias.zero_()
            layers += [conv, nn.ReLU()]
            cin = v
        self.features = nn.Sequential(*layers)

    def forward(self, x, taps=CONTENT_TAPS, dtype: torch.dtype | None = None) -> dict:
        """x NHWC -> {tap: activation} (NCHW on channels_last memory, in
        ``dtype``; None: x's own). Tap names count conv layers from 1:
        ``conv_i``, ``relu_i``, ``pool_i``."""
        h = (x if dtype is None else x.to(dtype)).permute(0, 3, 1, 2)
        dtype = h.dtype
        want, out, ci = set(taps), {}, 0
        for layer in self.features:
            if not want - out.keys():
                break
            if isinstance(layer, nn.Conv2d):
                ci += 1
                h = F.conv2d(h, layer.weight.to(dtype), layer.bias.to(dtype),
                             padding=layer.padding)
                name = f"conv_{ci}"
            elif isinstance(layer, nn.ReLU):
                # not in place: a tapped conv output must survive
                h, name = F.relu(h), f"relu_{ci}"
            else:
                h, name = layer(h), f"pool_{ci}"
            if name in want:
                out[name] = h
        return out


class VGG19Features(VGGFeatures):
    def __init__(self, generator=None):
        super().__init__("vgg19", generator)


class VGG16Features(VGGFeatures):
    def __init__(self, generator=None):
        super().__init__("vgg16", generator)


def gram_matrix(feat):
    """Gram matrix over spatial positions of NHWC features, [B, H, W, C] ->
    [B, C, C] / (C*H*W), as the JAX package's ``models/vgg.py:gram_matrix``."""
    b, h, w, c = feat.shape
    f = feat.reshape(b, h * w, c)
    return torch.bmm(f.transpose(1, 2), f) / (c * h * w)


def features_state_dict(sd) -> dict:
    """A torchvision vgg16 or vgg19 state_dict (``features.N.*``, or the bare
    ``N.*`` of a ``features`` module) -> this module's keys; a classifier's
    keys are dropped."""
    out = {}
    for k, v in sd.items():
        if k.startswith("features."):
            out[k] = v
        elif k[:1].isdigit():
            out[f"features.{k}"] = v
    return out
