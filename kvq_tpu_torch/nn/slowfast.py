"""SlowFast-R50, the motion-feature extractor (counterpart of
kvq_tpu/nn/slowfast.py), eval only.

The reference runs a frozen pytorchvideo ``slowfast_r50`` over per-second
32-frame clips and keeps the pooled slow (2048) and fast (256) features of
each clip (SlowFast_features.py:21,137-165,191-197).  Standard
SlowFast-R50: alpha 4, beta 1/8; the slow path's stem has temporal kernel
1 and its stages 1, 1, 3, 3; the fast path (width 8) has a stem of
temporal kernel 5 and 3 in every stage; the temporal kernel sits on each
bottleneck's first 1x1 conv; the first block of every stage carries the
projection shortcut; after the stem and stages 1-3 a (7, 1, 1) conv of
stride (4, 1, 1) and padding 3, BatchNorm and ReLU take the fast path to
the slow one, concatenated onto it.  BatchNorm runs on its running
statistics.

Names are pytorchvideo's (``blocks.0.multipathway_blocks.{0,1}.conv`` /
``norm``, ``blocks.{i}.multipathway_blocks.{p}.res_blocks.{b}.branch2.
conv_{a,b,c}`` / ``norm_{a,b,c}``, ``branch1_conv`` / ``branch1_norm``,
``blocks.{i}.multipathway_fusion.conv_fast_to_slow`` / ``norm``), so a
``torch.hub`` ``slowfast_r50`` state dict loads (its classification head,
``blocks.5`` onward, is reported unexpected).  Inputs are channels-last clips
(B, T, H, W, 3) normalised with the ``slowfast`` profile; output (slow
(B, 2048), fast (B, 256)), float32 global means.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import index_tensor
from .resnet import FrozenBatchNorm2d


def pack_pathways(frames):
    """(B, T, H, W, C) -> (slow: T // 4 frames at linspace indices, fast:
    all) — the reference's pack_pathway_output (SlowFast_features.py:
    112-135).  numpy arrays or tensors."""
    t = frames.shape[1]
    idx = np.linspace(0, t - 1, t // 4).astype(np.int64)
    if isinstance(frames, torch.Tensor):
        return frames.index_select(1, index_tensor(tuple(idx.tolist()),
                                                   frames.device)), frames
    return frames[:, idx], frames


class FrozenBatchNorm3d(nn.BatchNorm3d):
    """BatchNorm on running statistics only (the extractor is frozen)."""

    forward = FrozenBatchNorm2d.forward


def _conv(cin, cout, kernel, stride=(1, 1, 1)):
    return nn.Conv3d(cin, cout, kernel, stride=stride,
                     padding=tuple(k // 2 for k in kernel), bias=False)


class _Branch2(nn.Module):
    def __init__(self, cin, planes, t_kernel, stride):
        super().__init__()
        self.conv_a = _conv(cin, planes, (t_kernel, 1, 1))
        self.norm_a = FrozenBatchNorm3d(planes)
        self.conv_b = _conv(planes, planes, (1, 3, 3), (1, stride, stride))
        self.norm_b = FrozenBatchNorm3d(planes)
        self.conv_c = _conv(planes, planes * 4, (1, 1, 1))
        self.norm_c = FrozenBatchNorm3d(planes * 4)

    def forward(self, x):
        x = F.relu(self.norm_a(self.conv_a(x)))
        x = F.relu(self.norm_b(self.conv_b(x)))
        return self.norm_c(self.conv_c(x))


class _ResBlock(nn.Module):
    def __init__(self, cin, planes, t_kernel, stride, shortcut):
        super().__init__()
        if shortcut:
            self.branch1_conv = _conv(cin, planes * 4, (1, 1, 1),
                                      (1, stride, stride))
            self.branch1_norm = FrozenBatchNorm3d(planes * 4)
        self.shortcut = shortcut
        self.branch2 = _Branch2(cin, planes, t_kernel, stride)

    def forward(self, x):
        res = (self.branch1_norm(self.branch1_conv(x)) if self.shortcut
               else x)
        return F.relu(self.branch2(x) + res)


class _ResStage(nn.Module):
    def __init__(self, cin, planes, t_kernel, stride, n_blocks):
        super().__init__()
        self.res_blocks = nn.ModuleList(
            _ResBlock(cin if b == 0 else planes * 4, planes, t_kernel,
                      stride if b == 0 else 1, shortcut=b == 0)
            for b in range(n_blocks))

    def forward(self, x):
        for block in self.res_blocks:
            x = block(x)
        return x


class _Stem(nn.Module):
    def __init__(self, width, t_kernel):
        super().__init__()
        self.conv = nn.Conv3d(3, width, (t_kernel, 7, 7), stride=(1, 2, 2),
                              padding=(t_kernel // 2, 3, 3), bias=False)
        self.norm = FrozenBatchNorm3d(width)

    def forward(self, x):
        x = F.relu(self.norm(self.conv(x)))
        return F.max_pool3d(x, (1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1))


class _Fusion(nn.Module):
    """Fast -> slow lateral: 2 x the fast channels, concatenated on slow."""

    def __init__(self, fast_channels, alpha):
        super().__init__()
        self.conv_fast_to_slow = nn.Conv3d(
            fast_channels, 2 * fast_channels, (7, 1, 1), stride=(alpha, 1, 1),
            padding=(3, 0, 0), bias=False)
        self.norm = FrozenBatchNorm3d(2 * fast_channels)

    def forward(self, slow, fast):
        lat = F.relu(self.norm(self.conv_fast_to_slow(fast)))
        return torch.cat([slow, lat], dim=1)


class _Block(nn.Module):
    """One of pytorchvideo's ``blocks``: a module per pathway, then the
    fusion (none after the last stage)."""

    def __init__(self, paths, fusion):
        super().__init__()
        self.multipathway_blocks = nn.ModuleList(paths)
        if fusion is not None:
            self.multipathway_fusion = fusion
        self.fuses = fusion is not None

    def forward(self, slow, fast):
        slow = self.multipathway_blocks[0](slow)
        fast = self.multipathway_blocks[1](fast)
        if self.fuses:
            slow = self.multipathway_fusion(slow, fast)
        return slow, fast


class SlowFastR50(nn.Module):
    def __init__(self, layers=(3, 4, 6, 3), alpha: int = 4,
                 beta_inv: int = 8):
        super().__init__()
        slow_w, fast_w = 64, 64 // beta_inv
        slow_t, fast_t = (1, 1, 3, 3), (3, 3, 3, 3)
        blocks = [_Block([_Stem(slow_w, 1), _Stem(fast_w, 5)],
                         _Fusion(fast_w, alpha))]
        slow_in, fast_in = slow_w + 2 * fast_w, fast_w
        for i, n_blocks in enumerate(layers):
            stride = 1 if i == 0 else 2
            sp, fp = slow_w * 2 ** i, fast_w * 2 ** i
            last = i == len(layers) - 1
            blocks.append(_Block(
                [_ResStage(slow_in, sp, slow_t[i], stride, n_blocks),
                 _ResStage(fast_in, fp, fast_t[i], stride, n_blocks)],
                None if last else _Fusion(fp * 4, alpha)))
            slow_in, fast_in = sp * 4 + 2 * fp * 4, fp * 4
        self.blocks = nn.ModuleList(blocks)
        self.to(memory_format=torch.channels_last_3d)

    def forward(self, slow, fast):
        """slow (B, T/4, H, W, 3), fast (B, T, H, W, 3) -> (slow (B,
        2048), fast (B, 256)) float32."""
        dtype = self.blocks[0].multipathway_blocks[0].conv.weight.dtype
        s = slow.to(dtype).permute(0, 4, 1, 2, 3)  # NCDHW, channels-last
        f = fast.to(dtype).permute(0, 4, 1, 2, 3)
        for block in self.blocks:
            s, f = block(s, f)
        return s.float().mean(dim=(2, 3, 4)), f.float().mean(dim=(2, 3, 4))
