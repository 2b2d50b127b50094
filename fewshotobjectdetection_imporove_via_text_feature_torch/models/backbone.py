"""ResNet C4 backbone with FrozenBN, NCHW, detectron2 state-dict names.

Counterpart of the JAX package's ``models/backbone.py``: stem + res2..res4
(stride 16) for the RPN and ROI trunk, and the res5 stage the C4 ROI head
runs on pooled ROIs. Convolutions compute in the module's ``dtype`` (cast
of input and weight, as flax's ``dtype=`` with float32 params); parameters
stay float32.

The stem is the plain 7x7/2 convolution with symmetric padding 3. The JAX
package's space-to-depth stem computes the same function in a layout that
suits the TPU's matrix unit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

# ResNet stage specs: depth -> blocks per stage (res2, res3, res4, res5).
RESNET_STAGES = {
    14: (1, 1, 1, 1),  # tiny depth for tests only
    26: (2, 2, 2, 2),  # tiny multi-block depth for tests only
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


class FrozenBN(nn.Module):
    """BatchNorm with fixed statistics and affine parameters (buffers):
    y = x * (weight / sqrt(var + eps)) + (bias - mean * scale), eps 1e-5,
    detectron2's FrozenBatchNorm2d."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        scale = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return (x * scale.to(x.dtype)[None, :, None, None]
                + shift.to(x.dtype)[None, :, None, None])


class Conv2d(nn.Conv2d):
    """detectron2's Conv2d: a convolution with an optional ``norm`` child
    (the state-dict name ``<conv>.norm.*``), computed in ``x.dtype``."""

    def __init__(self, *args, norm: nn.Module | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.norm = norm

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        x = F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                     self.padding, self.dilation, self.groups)
        return x if self.norm is None else self.norm(x)


def _conv_bn(cin, cout, kernel, stride=1, dilation=1):
    pad = dilation * (kernel - 1) // 2
    return Conv2d(cin, cout, kernel, stride=stride, padding=pad,
                  dilation=dilation, bias=False, norm=FrozenBN(cout))


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with FrozenBN and a projection shortcut
    when the shape changes; ``stride_in_1x1`` puts the stride on conv1
    (Caffe/MSRA), else on conv2."""

    def __init__(self, in_channels, bottleneck_channels, out_channels,
                 stride=1, stride_in_1x1=True, dilation=1):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = _conv_bn(in_channels, bottleneck_channels, 1, s1)
        self.conv2 = _conv_bn(bottleneck_channels, bottleneck_channels, 3,
                              s3, dilation)
        self.conv3 = _conv_bn(bottleneck_channels, out_channels, 1)
        if in_channels != out_channels or stride != 1:
            self.shortcut = _conv_bn(in_channels, out_channels, 1, stride)
        else:
            self.shortcut = None

    def forward(self, x):
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        sc = x if self.shortcut is None else self.shortcut(x)
        return F.relu(out + sc)


class ResStage(nn.Sequential):
    """A sequence of bottleneck blocks; the first carries the stride.
    Children are named 0, 1, ... as in detectron2."""

    def __init__(self, num_blocks, in_channels, bottleneck_channels,
                 out_channels, first_stride, stride_in_1x1=True):
        super().__init__(*(
            BottleneckBlock(
                in_channels if i == 0 else out_channels, bottleneck_channels,
                out_channels, stride=first_stride if i == 0 else 1,
                stride_in_1x1=stride_in_1x1,
            )
            for i in range(num_blocks)
        ))


class Stem(nn.Module):
    """7x7/2 conv + FrozenBN + relu + 3x3/2 max pool."""

    def __init__(self, out_channels: int):
        super().__init__()
        self.conv1 = Conv2d(3, out_channels, 7, stride=2, padding=3,
                            bias=False, norm=FrozenBN(out_channels))

    def forward(self, x):
        x = F.relu(self.conv1(x))
        return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


class ResNetC4(nn.Module):
    """Stem + res2..res4 (stride 16 output), the RPN and ROI trunk.
    ``forward`` returns {"res2", "res3", "res4"} (B, C, H, W) maps. With
    ``remat`` (TPU.REMAT_BACKBONE) each trainable stage keeps only its
    input for the backward pass and recomputes the rest there
    (``torch.utils.checkpoint``): the same losses and gradients, less
    memory."""

    def __init__(self, depth=101, stem_out_channels=64, res2_out_channels=256,
                 num_groups=1, width_per_group=64, stride_in_1x1=True,
                 freeze_at=0, remat=False, dtype=torch.float32):
        super().__init__()
        self.freeze_at = freeze_at
        self.remat = remat
        self.dtype = dtype
        self.stem = Stem(stem_out_channels)
        blocks = RESNET_STAGES[depth]
        bottleneck = num_groups * width_per_group
        cin = stem_out_channels
        self.stage_names = ("res2", "res3", "res4")
        for idx, (name, n) in enumerate(zip(self.stage_names, blocks[:3])):
            cout = res2_out_channels * 2**idx
            self.add_module(name, ResStage(
                n, cin, bottleneck * 2**idx, cout,
                first_stride=1 if idx == 0 else 2,
                stride_in_1x1=stride_in_1x1,
            ))
            cin = cout

    def forward(self, x):
        # detectron2 freeze semantics (the stem is stage 1, res2 stage 2):
        # stages up to freeze_at pass no gradient, so they run without
        # autograd and keep no activations for a backward pass
        grad = torch.is_grad_enabled()
        with torch.set_grad_enabled(grad and self.freeze_at < 1):
            x = self.stem(x.to(self.dtype))
        feats = {}
        for idx, name in enumerate(self.stage_names):
            trains = grad and self.freeze_at < idx + 2
            stage = getattr(self, name)
            with torch.set_grad_enabled(trains):
                if self.remat and trains:
                    x = checkpoint(stage, x, use_reentrant=False)
                else:
                    x = stage(x)
            feats[name] = x
        return feats


class Res5Stage(ResStage):
    """The res5 stage of the C4 ROI head: bottleneck 512, out 2048.
    ``first_stride=1`` pairs with strided-bin-elided pooling (the pooler
    already emitted only the bins block0's stride-2 1x1 convs read); the
    parameters are the same either way."""

    def __init__(self, num_groups=1, width_per_group=64,
                 res2_out_channels=256, num_blocks=3, stride_in_1x1=True,
                 first_stride=2):
        factor = 2**3
        super().__init__(
            num_blocks, res2_out_channels * factor // 2,
            num_groups * width_per_group * factor,
            res2_out_channels * factor, first_stride=first_stride,
            stride_in_1x1=stride_in_1x1,
        )
