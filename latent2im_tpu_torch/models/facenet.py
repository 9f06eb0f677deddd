"""InceptionResnetV1 (facenet, VGGFace2) identity embedder, PyTorch port.

The counterpart of latent2im_tpu/models/facenet.py, which the reference's
eval.py:29-32 takes from facenet_pytorch to embed 160x160 faces for the
identity-preservation metric. Module and parameter names are
facenet_pytorch's (``conv2d_1a.conv.weight``, ``repeat_1.0.branch1.1.bn.
running_var``, ``block8.conv2d.bias``, ``last_bn.weight``, ...), the layout
latent2im_tpu/io/torch_convert.py:convert_facenet reads, so a facenet_pytorch
state_dict (``facenet_vggface2.pt``) loads with ``strict=True``; its
``logits`` classifier is held only when the state_dict has one
(``from_state_dict``). BatchNorm runs frozen (eps 1e-3, eval mode).

Structure: stem convs -> 5x Block35 (scale .17) -> Mixed_6a -> 10x Block17
(scale .10) -> Mixed_7a -> 5x Block8 (scale .20) -> Block8(noReLU) ->
global avgpool -> Linear(1792->512, no bias) -> BatchNorm1d -> L2 normalize.
Input NHWC [B, 160, 160, 3], output [B, 512] f32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-3


def _normal_(t, std, generator):
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=generator) * std)


class BasicConv2d(nn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=0, generator=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)
        _normal_(self.conv.weight, 0.05, generator)  # the JAX package's init

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _conv_b(cin, cout, generator):
    conv = nn.Conv2d(cin, cout, 1)
    _normal_(conv.weight, 0.05, generator)
    with torch.no_grad():
        conv.bias.zero_()
    return conv


class Block35(nn.Module):
    def __init__(self, scale=0.17, generator=None):
        super().__init__()
        g = generator
        self.scale = scale
        self.branch0 = BasicConv2d(256, 32, 1, generator=g)
        self.branch1 = nn.Sequential(BasicConv2d(256, 32, 1, generator=g),
                                     BasicConv2d(32, 32, 3, padding=1, generator=g))
        self.branch2 = nn.Sequential(BasicConv2d(256, 32, 1, generator=g),
                                     BasicConv2d(32, 32, 3, padding=1, generator=g),
                                     BasicConv2d(32, 32, 3, padding=1, generator=g))
        self.conv2d = _conv_b(96, 256, g)

    def forward(self, x):
        up = torch.cat([self.branch0(x), self.branch1(x), self.branch2(x)], 1)
        return F.relu(x + self.scale * self.conv2d(up))


class Block17(nn.Module):
    def __init__(self, scale=0.10, generator=None):
        super().__init__()
        g = generator
        self.scale = scale
        self.branch0 = BasicConv2d(896, 128, 1, generator=g)
        self.branch1 = nn.Sequential(
            BasicConv2d(896, 128, 1, generator=g),
            BasicConv2d(128, 128, (1, 7), padding=(0, 3), generator=g),
            BasicConv2d(128, 128, (7, 1), padding=(3, 0), generator=g))
        self.conv2d = _conv_b(256, 896, g)

    def forward(self, x):
        up = torch.cat([self.branch0(x), self.branch1(x)], 1)
        return F.relu(x + self.scale * self.conv2d(up))


class Block8(nn.Module):
    def __init__(self, scale=0.20, relu=True, generator=None):
        super().__init__()
        g = generator
        self.scale, self.relu = scale, relu
        self.branch0 = BasicConv2d(1792, 192, 1, generator=g)
        self.branch1 = nn.Sequential(
            BasicConv2d(1792, 192, 1, generator=g),
            BasicConv2d(192, 192, (1, 3), padding=(0, 1), generator=g),
            BasicConv2d(192, 192, (3, 1), padding=(1, 0), generator=g))
        self.conv2d = _conv_b(384, 1792, g)

    def forward(self, x):
        up = torch.cat([self.branch0(x), self.branch1(x)], 1)
        out = x + self.scale * self.conv2d(up)
        return F.relu(out) if self.relu else out


class Mixed6a(nn.Module):
    def __init__(self, generator=None):
        super().__init__()
        g = generator
        self.branch0 = BasicConv2d(256, 384, 3, stride=2, generator=g)
        self.branch1 = nn.Sequential(
            BasicConv2d(256, 192, 1, generator=g),
            BasicConv2d(192, 192, 3, padding=1, generator=g),
            BasicConv2d(192, 256, 3, stride=2, generator=g))
        self.branch2 = nn.MaxPool2d(3, stride=2)

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x)], 1)


class Mixed7a(nn.Module):
    def __init__(self, generator=None):
        super().__init__()
        g = generator
        self.branch0 = nn.Sequential(BasicConv2d(896, 256, 1, generator=g),
                                     BasicConv2d(256, 384, 3, stride=2, generator=g))
        self.branch1 = nn.Sequential(BasicConv2d(896, 256, 1, generator=g),
                                     BasicConv2d(256, 256, 3, stride=2, generator=g))
        self.branch2 = nn.Sequential(BasicConv2d(896, 256, 1, generator=g),
                                     BasicConv2d(256, 256, 3, padding=1, generator=g),
                                     BasicConv2d(256, 256, 3, stride=2, generator=g))
        self.branch3 = nn.MaxPool2d(3, stride=2)

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          self.branch3(x)], 1)


class InceptionResnetV1(nn.Module):
    """facenet_pytorch's InceptionResnetV1 in eval mode, as an embedder.
    ``generator`` seeds the JAX package's random init (conv weights
    N(0, 0.05^2), the linear N(0, 0.02^2), identity BatchNorm);
    ``num_classes`` adds the ``logits`` layer a pretrained state_dict
    carries (unused by the embedding)."""

    def __init__(self, num_classes: int | None = None, generator=None):
        super().__init__()
        g = generator
        self.conv2d_1a = BasicConv2d(3, 32, 3, stride=2, generator=g)
        self.conv2d_2a = BasicConv2d(32, 32, 3, generator=g)
        self.conv2d_2b = BasicConv2d(32, 64, 3, padding=1, generator=g)
        self.maxpool_3a = nn.MaxPool2d(3, stride=2)
        self.conv2d_3b = BasicConv2d(64, 80, 1, generator=g)
        self.conv2d_4a = BasicConv2d(80, 192, 3, generator=g)
        self.conv2d_4b = BasicConv2d(192, 256, 3, stride=2, generator=g)
        self.repeat_1 = nn.Sequential(*[Block35(generator=g) for _ in range(5)])
        self.mixed_6a = Mixed6a(generator=g)
        self.repeat_2 = nn.Sequential(*[Block17(generator=g) for _ in range(10)])
        self.mixed_7a = Mixed7a(generator=g)
        self.repeat_3 = nn.Sequential(*[Block8(generator=g) for _ in range(5)])
        self.block8 = Block8(scale=1.0, relu=False, generator=g)
        self.last_linear = nn.Linear(1792, 512, bias=False)
        _normal_(self.last_linear.weight, 0.02, g)
        self.last_bn = nn.BatchNorm1d(512, eps=BN_EPS)
        if num_classes is not None:
            self.logits = nn.Linear(512, num_classes)
        self.eval()

    @classmethod
    def from_state_dict(cls, sd) -> "InceptionResnetV1":
        """A facenet_pytorch state_dict (or module) loaded with strict=True."""
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        n_cls = sd["logits.weight"].shape[0] if "logits.weight" in sd else None
        model = cls(num_classes=n_cls)
        model.load_state_dict(sd, strict=True)
        return model.eval()

    def forward(self, x):
        """x NHWC [B, 160, 160, 3] (facenet's (img - 127.5) / 128 scale, or
        the reference eval's raw 0-255) -> L2-normalized [B, 512] f32."""
        x = x.permute(0, 3, 1, 2)
        for name in ("conv2d_1a", "conv2d_2a", "conv2d_2b", "maxpool_3a", "conv2d_3b",
                     "conv2d_4a", "conv2d_4b", "repeat_1", "mixed_6a", "repeat_2",
                     "mixed_7a", "repeat_3", "block8"):
            x = getattr(self, name)(x)
        x = self.last_bn(self.last_linear(x.mean((2, 3))))
        return F.normalize(x, p=2, dim=1).float()
