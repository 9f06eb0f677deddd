"""ResNet-50 attribute regressor (torchvision v1 layout), PyTorch port.

The counterpart of latent2im_tpu/models/resnet.py:24-334 in inference: the
Bottleneck [3, 4, 6, 3] network with eval-mode BatchNorm (eps 1e-5), max-pool
3/2/1, a global mean and fc -> ``num_outputs`` (40 CelebA attributes), f32
logits. Parameter names follow torchvision (``conv1.weight``,
``layer1.0.downsample.1.running_var``, ``fc.bias``, ...), so a torchvision
state_dict with its fc replaced loads as it is. Written by hand, since the
port may not depend on torchvision.

The public input is NHWC; inside, the NCHW-logical tensor keeps channels_last
memory, which is what cuDNN's convolutions run fastest on. The JAX package's
s2d stem is a TPU layout trick computing the same function, not ported.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

LAYERS = (3, 4, 6, 3)
EXPANSION = 4


def _conv(cin, cout, k, stride=1, padding=0, generator=None):
    conv = nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False)
    # torchvision's init: kaiming_normal_(mode='fan_out', nonlinearity='relu')
    std = math.sqrt(2.0 / (k * k * cout))
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=generator) * std)
    return conv


class Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride, downsample: bool, generator=None):
        super().__init__()
        self.conv1 = _conv(cin, planes, 1, generator=generator)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride, 1, generator=generator)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * EXPANSION, 1, generator=generator)
        self.bn3 = nn.BatchNorm2d(planes * EXPANSION)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                _conv(cin, planes * EXPANSION, 1, stride, generator=generator),
                nn.BatchNorm2d(planes * EXPANSION),
            )

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        idn = x if self.downsample is None else self.downsample(x)
        return self.relu(out + idn)


class ResNet50(nn.Module):
    def __init__(self, num_outputs: int = 40, generator=None):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2, 3, generator=generator)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin, planes = 64, 64
        for li, n_blocks in enumerate(LAYERS):
            blocks = []
            for bi in range(n_blocks):
                stride = (1 if li == 0 else 2) if bi == 0 else 1
                down = bi == 0 and (stride != 1 or cin != planes * EXPANSION)
                blocks.append(Bottleneck(cin, planes, stride, down, generator))
                cin = planes * EXPANSION
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
            planes *= 2
        self.fc = nn.Linear(2048, num_outputs)
        bound = 1.0 / math.sqrt(2048)
        with torch.no_grad():
            self.fc.weight.copy_(
                torch.rand(self.fc.weight.shape, generator=generator) * 2 * bound - bound
            )
            self.fc.bias.zero_()
        self.eval()

    def forward(self, x):
        """x [B, H, W, 3] NHWC -> logits [B, num_outputs] f32."""
        x = x.permute(0, 3, 1, 2)  # NCHW view of channels_last memory
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for li in range(len(LAYERS)):
            x = getattr(self, f"layer{li + 1}")(x)
        return self.fc(x.mean((2, 3))).float()
