"""Regression heads (counterparts of kvq_tpu/nn/heads.py).

  - :class:`VQAHead` (:32; reference models/head.py:42-68): dropout ->
    1x1x1 conv -> exact GELU -> dropout -> 1x1x1 conv, mean over (T, H,
    W).  The convs keep the reference's Conv3d parameters and run as
    channels-last matmuls; the dropouts (rate 0.5) act in training only
    and draw from the caller's generator.
  - :class:`SimpleVQAHead` (:16-29; reference head.py:19-31): Linear(in,
    hidden) -> Linear(hidden, 1) with no activation between them, mean over
    frames; parameters ``quality.{0,1}``, as the reference's
    ``simpleVQA_head``.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .layers import conv1x1, dropout


class VQAHead(nn.Module):
    def __init__(self, in_channels: int = 768, hidden_channels: int = 64,
                 num_class: int = 1, dropout_ratio: float = 0.5):
        super().__init__()
        self.num_class = num_class
        self.dropout_ratio = dropout_ratio
        self.fc_hid = nn.Conv3d(in_channels, hidden_channels, 1)
        self.fc_last = nn.Conv3d(hidden_channels, num_class, 1)

    def _drop(self, x, gen):
        if not self.training or self.dropout_ratio == 0.0:
            return x
        return dropout(x, self.dropout_ratio, gen)

    def forward(self, x, gen=None):
        # x: (B, T, H, W, C) channels-last
        x = F.gelu(conv1x1(self.fc_hid, self._drop(x, gen)))
        x = conv1x1(self.fc_last, self._drop(x, gen))
        if self.num_class > 1:
            x = x.softmax(dim=-1)
        return x.mean(dim=(1, 2, 3))


class SimpleVQAHead(nn.Module):
    def __init__(self, in_channels: int = 9472, hidden_channels: int = 128):
        super().__init__()
        self.quality = nn.Sequential(nn.Linear(in_channels, hidden_channels),
                                     nn.Linear(hidden_channels, 1))

    def forward(self, x, gen=None):
        # x: (B, T, in_channels), float32 features; the products run in the
        # weights' dtype, as flax's Dense casts its input to its dtype
        return self.quality(x.to(self.quality[0].weight.dtype)).mean(dim=1)
