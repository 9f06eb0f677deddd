"""LPIPS perceptual metric, 'vgg' variant — PyTorch port of
latent2im_tpu/models/lpips.py (Zhang et al. 2018, "The Unreasonable
Effectiveness of Deep Features as a Perceptual Metric"):

    x in [-1, 1] -> fixed channel scaling -> VGG16 relu1_2/2_2/3_3/4_3/5_3
    -> unit-normalize each feature map over channels
    -> squared difference -> learned non-negative 1x1 head per tap
    -> spatial mean -> sum over taps.

The backbone is models/vgg.py:VGG16Features (taps ``relu_2`` .. ``relu_13``
in its naming); the heads keep the PerceptualSimilarity release's names
(``lin{i}.model.1.weight``, [1, C, 1, 1]), so ``from_state_dicts`` loads
its ``vgg.pth`` beside a torchvision vgg16 state dict. Plain PyTorch: the
JAX counterpart reaches no Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .vgg import VGG16Features, features_state_dict

# relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
LPIPS_TAPS = ("relu_2", "relu_4", "relu_7", "relu_10", "relu_13")
LPIPS_CHANNELS = (64, 128, 256, 512, 512)
# the official ScalingLayer's shift and scale of [-1, 1] inputs
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class _NetLin(nn.Module):
    """The release's NetLinLayer: Dropout (inactive in eval), then a 1x1
    conv to one channel without bias."""

    def __init__(self, channels: int, generator=None):
        super().__init__()
        conv = nn.Conv2d(channels, 1, 1, bias=False)
        with torch.no_grad():  # the JAX package's random heads: U(0, 0.1)
            conv.weight.copy_(torch.rand(conv.weight.shape, generator=generator) * 0.1)
        self.model = nn.Sequential(nn.Dropout(), conv)


class LPIPS(nn.Module):
    """LPIPS(x0, x1) -> [B]; ``generator`` seeds random heads and backbone
    (tests, smoke runs); real runs load the released weights
    (``from_state_dicts``)."""

    def __init__(self, generator=None):
        super().__init__()
        self.vgg = VGG16Features(generator)
        for i, c in enumerate(LPIPS_CHANNELS):
            setattr(self, f"lin{i}", _NetLin(c, generator))
        self.eval()

    @classmethod
    def from_state_dicts(cls, lin_sd: dict, vgg16_sd: dict) -> "LPIPS":
        """The release's ``vgg.pth`` heads (``lin{i}.model.1.weight``, or
        ``lins.{i}.model.1.weight`` as some packagings name them) and a
        torchvision vgg16 state dict (``features.N.*`` or bare ``N.*``),
        loaded strict."""
        sd = {f"vgg.{k}": v for k, v in features_state_dict(vgg16_sd).items()}
        for i, c in enumerate(LPIPS_CHANNELS):
            for k in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
                if k in lin_sd:
                    w = torch.as_tensor(lin_sd[k]).reshape(-1)
                    break
            else:
                raise KeyError(f"LPIPS lin head {i} not found in state dict")
            if w.shape[0] != c:
                raise ValueError(f"lin{i} has {w.shape[0]} channels, expected {c}")
            sd[f"lin{i}.model.1.weight"] = w.reshape(1, c, 1, 1)
        net = cls()
        net.load_state_dict(sd, strict=True)
        return net

    def _features(self, x):
        shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
        scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)
        return self.vgg((x - shift) / scale, LPIPS_TAPS)

    def forward(self, x0, x1):
        """x0, x1: NHWC images in [-1, 1] -> [B]."""
        f0, f1 = self._features(x0), self._features(x1)
        total = 0.0
        for i, tap in enumerate(LPIPS_TAPS):  # features NCHW: channels on dim 1
            d = torch.square(_unit_normalize(f0[tap]) - _unit_normalize(f1[tap]))
            w = getattr(self, f"lin{i}").model[1].weight  # [1, C, 1, 1]
            total = total + torch.mean(torch.sum(d * w, dim=1), dim=(1, 2))
        return total


def _unit_normalize(f, eps: float = 1e-10):
    norm = torch.sqrt(torch.sum(torch.square(f), dim=1, keepdim=True))
    return f / (norm + eps)
