"""VQAHead (counterpart of kvq_tpu/nn/heads.py:32; reference
models/head.py:42-68): 1x1x1 conv -> exact GELU -> 1x1x1 conv, mean over
(T, H, W).  The convs keep the reference's Conv3d parameters and run as
channels-last matmuls."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .layers import conv1x1


class VQAHead(nn.Module):
    def __init__(self, in_channels: int = 768, hidden_channels: int = 64,
                 num_class: int = 1):
        super().__init__()
        self.num_class = num_class
        self.fc_hid = nn.Conv3d(in_channels, hidden_channels, 1)
        self.fc_last = nn.Conv3d(hidden_channels, num_class, 1)

    def forward(self, x):
        # x: (B, T, H, W, C) channels-last; dropout is off at eval
        x = conv1x1(self.fc_last, F.gelu(conv1x1(self.fc_hid, x)))
        if self.num_class > 1:
            x = x.softmax(dim=-1)
        return x.mean(dim=(1, 2, 3))
