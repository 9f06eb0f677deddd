"""ResNet-50 attribute regressor (torchvision v1 layout), PyTorch port.

The counterpart of latent2im_tpu/models/resnet.py:24-345: the Bottleneck
[3, 4, 6, 3] network with BatchNorm (eps 1e-5), max-pool 3/2/1, a global mean
and fc -> ``num_outputs`` (40 CelebA attributes), f32 logits. The module
starts in eval mode (the frozen regressor of the editor: BN from its running
statistics); the regressor trainer (cli/train_regressor.py) alone calls
``.train()``. In train mode ``nn.BatchNorm2d`` computes what the JAX
package's ``batch_norm(train=True)`` + ``apply_bn_stats`` do: it normalises
with the batch's biased variance and moves the running statistics by
momentum 0.1, the variance made unbiased by n / (n - 1). Parameter names
follow torchvision (``conv1.weight``,
``layer1.0.downsample.1.running_var``, ``fc.bias``, ...), so a torchvision
state_dict with its fc replaced loads as it is. Written by hand, since the
port may not depend on torchvision.

The public input is NHWC; inside, the NCHW-logical tensor keeps channels_last
memory, which is what cuDNN's convolutions run fastest on. The JAX package's
s2d stem is a TPU layout trick computing the same function, not ported.

``forward(x, dtype=torch.bfloat16)`` is the JAX package's bf16 forward: the
image cast to bf16, each conv's and fc's f32 weights cast per call, BN on
the bf16 activations with its f32 statistics (in f32 arithmetic, one
rounding, where the JAX package's ``(x - mean) * (inv * gamma) + beta``
rounds after each of its three bf16 operations), f32 logits.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

LAYERS = (3, 4, 6, 3)
EXPANSION = 4


def _conv(cin, cout, k, stride=1, padding=0, generator=None):
    conv = nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False)
    # torchvision's init: kaiming_normal_(mode='fan_out', nonlinearity='relu')
    std = math.sqrt(2.0 / (k * k * cout))
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=generator) * std)
    return conv


def _c(conv, x):
    """``conv`` (bias-free) in x's dtype, its weight cast per call."""
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding)


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
        out = self.relu(self.bn1(_c(self.conv1, x)))
        out = self.relu(self.bn2(_c(self.conv2, out)))
        out = self.bn3(_c(self.conv3, out))
        idn = x if self.downsample is None else self.downsample[1](
            _c(self.downsample[0], x))
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
        # the JAX package's init_resnet50: fc weight U(-1/sqrt(2048), ..),
        # bias 0 (the convs: _conv's kaiming normal, fan_out)
        bound = 1.0 / math.sqrt(2048)
        with torch.no_grad():
            self.fc.weight.copy_(
                torch.rand(self.fc.weight.shape, generator=generator) * 2 * bound - bound
            )
            self.fc.bias.zero_()
        self.eval()  # the frozen regressor; the trainer calls .train()

    def forward(self, x, dtype: torch.dtype | None = None):
        """x [B, H, W, 3] NHWC -> logits [B, num_outputs] f32, computed in
        ``dtype`` (None: x's own)."""
        x = x if dtype is None else x.to(dtype)
        dtype = x.dtype
        x = x.permute(0, 3, 1, 2)  # NCHW view of channels_last memory
        x = self.maxpool(self.relu(self.bn1(_c(self.conv1, x))))
        for li in range(len(LAYERS)):
            x = getattr(self, f"layer{li + 1}")(x)
        return F.linear(x.mean((2, 3)), self.fc.weight.to(dtype),
                        self.fc.bias.to(dtype)).float()
