"""ResNet (v1.5, torchvision layout), counterpart of kvq_tpu/nn/resnet.py.
Modules take NCHW; parameter and buffer names are torchvision's.

  - CONTRIQUE's encoder: :class:`ResNetTrunk`, the reference's
    ``Sequential(*resnet50.children()[:-2])`` (children 0 conv1, 1 bn1,
    2 relu, 3 maxpool, 4-7 layer1-4), with :class:`FrozenBatchNorm2d`;
  - SimpleVQA's spatial branch: :class:`FeatureResNet` (the reference's
    ``simpleVQA_backbone``, simpleVQA_model.py:240-262), trainable, with
    :class:`BatchNorm`, which follows flax's ``nn.BatchNorm`` as the JAX
    package runs it:

      * statistics in float32 whatever the compute dtype;
      * the running variance is updated with the *biased* batch variance
        (torch's BatchNorm2d uses the unbiased one), and the output is
        normalised with the biased variance;
      * ``ra = 0.9 * ra + 0.1 * batch`` (flax momentum 0.9 is torch's
        0.1), applied in place under ``no_grad``, so a forward that runs on
        the module's own buffers updates them once;
      * eval normalises with the running statistics.

In a data-parallel run (:func:`sync_batchnorm`) the train-mode statistics
are those of the whole batch across the ranks, as the JAX package's
``bn_axis_name`` makes them: flax's ``axis_name`` path.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel.steps import all_reduce_mean
from .layers import avg_std_pool


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm on running statistics only (the encoder is frozen)."""

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


BN_MOMENTUM = 0.9  # flax's: ra = 0.9 * ra + 0.1 * batch
BN_EPS = 1e-5


class BatchNorm(nn.BatchNorm2d):
    """flax's BatchNorm on NCHW (see the module docstring).  Train mode is
    one ``F.batch_norm`` call: it normalises with the batch statistics,
    carries the gradient, and with momentum 1 writes the batch mean and
    the unbiased batch variance into two scratch vectors; the running
    statistics then fold in the mean and the biased variance (the
    unbiased one times (n - 1) / n).  The variance is computed about the
    mean, where flax's E[x^2] - E[x]^2 loses about eps_f32 * mean^2 / var
    of its relative accuracy.  Eval mode normalises with the running
    statistics.  Weight, bias and statistics stay float32 under a bf16
    compute dtype (``models/vqa_network.py:f32_names``)."""

    process_group = None  # set by sync_batchnorm in a data-parallel run

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS)

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if self.process_group is not None:
            return self._synced(x)
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                         self.eps)
        n = x.numel() // x.shape[1]
        # the scratch vectors are saved for backward
        self._fold(mean, var * ((n - 1) / n if n > 1 else 0.0))
        return y

    def _synced(self, x):
        """flax's ``axis_name`` path: the per-channel mean and E[x^2] in
        at least float32, averaged over the ranks by one differentiable
        all-reduce (every rank's batch is as large), the variance E[x^2] -
        mean^2 (clipped at 0), the normalisation in that precision."""
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        c = x.shape[1]
        dims = (0, 2, 3)
        stats = all_reduce_mean(torch.cat([xf.mean(dims),
                                           (xf * xf).mean(dims)]),
                                self.process_group)
        mean, mean2 = stats[:c], stats[c:]
        var = (mean2 - mean * mean).clamp_min(0.0)
        scale = torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype)
        y = ((xf - mean[:, None, None]) * scale[:, None, None]
             + self.bias.to(xf.dtype)[:, None, None])
        self._fold(mean, var)
        return y.to(x.dtype)

    @torch.no_grad()
    def _fold(self, mean, biased_var):
        self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
        self.running_var.mul_(BN_MOMENTUM).add_(biased_var,
                                                alpha=1 - BN_MOMENTUM)
        self.num_batches_tracked.add_(1)


def sync_batchnorm(model: nn.Module, group=None) -> None:
    """Average the train-mode statistics of every :class:`BatchNorm` of
    ``model`` over the ranks of ``group`` (the default group when None).
    At one rank nothing changes."""
    if dist.get_world_size(group) > 1:
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.process_group = group or dist.group.WORLD


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, norm=FrozenBatchNorm2d):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = norm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = norm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = norm(planes * 4)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
                norm(planes * 4),
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


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, norm=BatchNorm):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = norm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = norm(planes)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False),
                norm(planes),
            )

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(y + res)


_BLOCKS = {"basic": BasicBlock, "bottleneck": BottleneckBlock}


class ResNet(nn.Module):
    """Stem and four stages with trainable :class:`BatchNorm`, under
    torchvision's names (``conv1``, ``bn1``, ``layer{1-4}.{b}``); the
    counterpart of kvq_tpu/nn/resnet.py's ResNetStem + ResNetTrunk.
    :meth:`stages` returns the four stages' maps."""

    def __init__(self, layers=(3, 4, 6, 3), block: str = "bottleneck"):
        super().__init__()
        block_cls = _BLOCKS[block]
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        inplanes = 64
        for stage, n_blocks in enumerate(layers):
            planes = 64 * 2 ** stage
            stride = 1 if stage == 0 else 2
            out = planes * block_cls.expansion
            blocks = []
            for b in range(n_blocks):
                ds = b == 0 and (stride != 1 or inplanes != out)
                blocks.append(block_cls(inplanes, planes,
                                        stride if b == 0 else 1, ds,
                                        norm=BatchNorm))
                inplanes = out
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.n_stages = len(layers)
        # cuDNN's NHWC convolutions: the input arrives channels-last
        self.to(memory_format=torch.channels_last)

    def stages(self, x) -> list:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = []
        for i in range(self.n_stages):
            x = getattr(self, f"layer{i + 1}")(x)
            feats.append(x)
        return feats


class FeatureResNet(ResNet):
    """SimpleVQA's spatial branch (kvq_tpu/nn/resnet.py:159-189): per frame,
    the float32 average and standard-deviation pools of stages 2, 3 and 4
    (2 x (512 + 1024 + 2048) = 7168 values), concatenated with the
    precomputed SlowFast features ``feat``.  Input ``simpleVQA`` (B, T, H,
    W, 3) and ``feat`` (B, T, 2304); output (B, T, 9472) float32.  The
    reference backbone's in-model ``quality`` head, which its forward
    bypasses, is not built: a reference ``.pth`` reports it unexpected."""

    num_features = 2 * (512 + 1024 + 2048) + 2304

    def __init__(self, layers=(3, 4, 6, 3)):
        super().__init__(layers)

    def forward(self, inputs: dict, gen=None):
        x = inputs["simpleVQA"]
        B, T, H, W, C = x.shape
        dtype = self.conv1.weight.dtype
        # (B*T, H, W, C) read as NCHW: channels-last strides, no copy
        x = x.reshape(B * T, H, W, C).to(dtype).permute(0, 3, 1, 2)
        pooled = []
        for f in self.stages(x)[1:]:
            mean, std = avg_std_pool(f, (2, 3))
            pooled += [mean, std]
        y = torch.cat(pooled, dim=-1).reshape(B, T, -1)
        return torch.cat([y, inputs["feat"].float()], dim=-1)
