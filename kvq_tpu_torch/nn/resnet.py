"""ResNet (v1.5, torchvision layout) with frozen BatchNorm — the CONTRIQUE
encoder (counterpart of kvq_tpu/nn/resnet.py's BottleneckBlock and
ResNetTrunk).  Modules take NCHW; parameter names are torchvision's, and
:class:`ResNetTrunk` is the reference's ``Sequential(*resnet50.children()
[:-2])`` (children 0 conv1, 1 bn1, 2 relu, 3 maxpool, 4-7 layer1-4)."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm on running statistics only (the encoder is frozen)."""

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
                FrozenBatchNorm2d(planes * 4),
            )

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(y + res)


class ResNetTrunk(nn.Sequential):
    """Stem + four bottleneck stages; returns the last stage's map."""

    def __init__(self, layers=(3, 4, 6, 3)):
        stages = []
        inplanes = 64
        for stage, n_blocks in enumerate(layers):
            planes = 64 * 2 ** stage
            stride = 1 if stage == 0 else 2
            blocks = []
            for b in range(n_blocks):
                ds = b == 0 and (stride != 1 or inplanes != planes * 4)
                blocks.append(BottleneckBlock(inplanes, planes,
                                              stride if b == 0 else 1, ds))
                inplanes = planes * 4
            stages.append(nn.Sequential(*blocks))
        super().__init__(
            nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False),
            FrozenBatchNorm2d(64),
            nn.ReLU(),
            nn.MaxPool2d(3, stride=2, padding=1),
            *stages,
        )
