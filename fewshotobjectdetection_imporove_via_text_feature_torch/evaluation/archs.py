"""The torchvision ResNet-101 that PCB runs (ref
defrcn/evaluation/archs/resnet.py:118-212), counterpart of the JAX package's
``evaluation/archs.py``; kept here because there is no torchvision.

Unlike the detection backbone: the stride sits on the 3x3 conv (torchvision's
convention), all four stages are present (output stride 32), then a global
average pool and ``fc`` (1000). BN runs with frozen statistics, eps 1e-5 (PCB
only evaluates). ``forward`` returns (fc logits, res5 map).

The modules carry torchvision's own state-dict names (``conv1``, ``bn1``,
``layer{1..4}.{b}.conv{1..3}``/``bn{1..3}``/``downsample.{0,1}``, ``fc``), so
a torchvision R-101 state dict (resnet101-5d3b4d8f.pth, the file
TEST.PCB_MODELPATH names) loads by name; ``torchvision_r101_manifest`` is its
key list.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..models.backbone import RESNET_STAGES, FrozenBN


class Bottleneck(nn.Module):
    """torchvision's bottleneck: 1x1 -> 3x3 (stride) -> 1x1, FrozenBN after
    each, a ``downsample`` projection when the shape changes."""

    def __init__(self, cin, planes, stride=1):
        super().__init__()
        cout = planes * 4
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = FrozenBN(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = FrozenBN(planes)
        self.conv3 = nn.Conv2d(planes, cout, 1, bias=False)
        self.bn3 = FrozenBN(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride=stride, bias=False),
                FrozenBN(cout))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        sc = x if self.downsample is None else self.downsample(x)
        return F.relu(out + sc)


class TorchvisionResNet(nn.Module):
    def __init__(self, depth: int = 101, num_classes: int = 1000):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBN(64)
        cin = 64
        for i, n in enumerate(RESNET_STAGES[depth]):
            planes = 64 * 2**i
            blocks = [Bottleneck(cin, planes, 1 if i == 0 else 2)]
            cin = planes * 4
            blocks += [Bottleneck(cin, planes) for _ in range(n - 1)]
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(cin, num_classes)

    def forward(self, x):
        """x (B, 3, H, W) normalized -> (logits (B, 1000), res5 map (B,
        2048, H/32, W/32))."""
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return self.fc(x.mean(dim=(2, 3))), x


@torch.no_grad()
def init_tv_weights(model: TorchvisionResNet,
                    generator: torch.Generator) -> TorchvisionResNet:
    """Seeded weights for a run without TEST.PCB_MODELPATH, with the JAX
    package's initialisers: He fan-out truncated normal convolutions, zero
    conv3 in every block (a random deep ResNet with identity FrozenBN stays
    bounded), identity FrozenBN, a LeCun-normal ``fc`` and zero bias."""
    for name, param in model.named_parameters():
        if name == "fc.bias":
            param.zero_()
        elif name == "fc.weight":
            std = math.sqrt(1.0 / param.shape[1]) / 0.87962566103423978
            nn.init.trunc_normal_(param, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        elif name.endswith("conv3.weight"):
            param.zero_()
        else:
            fan_out = param.shape[0] * param.shape[2] * param.shape[3]
            std = math.sqrt(2.0 / fan_out) / 0.87962566103423978
            nn.init.trunc_normal_(param, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
    return model


def torchvision_r101_manifest():
    """The key list of the torchvision ResNet-101 state dict
    (resnet101-5d3b4d8f.pth, which predates ``num_batches_tracked``): 522
    tensors of the [3, 4, 23, 3] bottleneck layout."""
    bn_leaves = ("weight", "bias", "running_mean", "running_var")
    keys = ["conv1.weight"] + [f"bn1.{leaf}" for leaf in bn_leaves]
    for li, n in enumerate((3, 4, 23, 3), start=1):
        for b in range(n):
            p = f"layer{li}.{b}"
            for c in (1, 2, 3):
                keys.append(f"{p}.conv{c}.weight")
                keys += [f"{p}.bn{c}.{leaf}" for leaf in bn_leaves]
            if b == 0:
                keys.append(f"{p}.downsample.0.weight")
                keys += [f"{p}.downsample.1.{leaf}" for leaf in bn_leaves]
    keys += ["fc.weight", "fc.bias"]
    return keys
