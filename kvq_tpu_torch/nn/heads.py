"""Regression heads (counterparts of kvq_tpu/nn/heads.py).

  - :class:`VQAHead` (:32; reference models/head.py:42-68): dropout ->
    1x1x1 conv -> exact GELU -> dropout -> 1x1x1 conv, mean over (T, H,
    W).  The convs keep the reference's Conv3d parameters and run as
    channels-last matmuls; the dropouts (rate 0.5) act in training only
    and draw from the caller's generator.
  - :class:`SimpleVQAHead` (:16-29; reference head.py:19-31): Linear(in,
    hidden) -> Linear(hidden, 1) with no activation between them, mean over
    frames; parameters ``quality.{0,1}``, as the reference's
    ``simpleVQA_head``;
  - :class:`IQAHead` (:55-73; reference head.py:143-173): VQAHead's layers
    as Linear, the mean over the last three axes of the projection (so
    (B, T, H, W, C) gives (B, T), reference head.py:172);
  - :class:`VARHead` (:76-90; reference head.py:116-141): dropout -> mean
    over (T, H, W) kept as axes -> 1x1x1 conv, (B, out_channels);
  - :class:`MaxVQAHead` (:93-121; reference head.py:72-113): dropout ->
    1x1x1 conv to ``out_dims`` groups of ``hidden_channels_per_dim`` ->
    exact GELU -> dropout -> a grouped 1x1x1 conv (``groups=out_dims``,
    the reference's Conv3d layout (out_dims, hidden, 1, 1, 1); the JAX
    package keeps it as ``fc_last_kernel`` (out_dims, hidden)), mean over
    (T, H, W), (B, out_dims).

Every dropout acts in training only and draws from the caller's generator,
in the order of the layers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import conv1x1, maybe_dropout


class _Dropout(nn.Module):
    """The heads' dropouts: rate ``dropout_ratio``, in training only."""

    def _drop(self, x, gen):
        return maybe_dropout(x, self.dropout_ratio, self.training, gen)


class VQAHead(_Dropout):
    def __init__(self, in_channels: int = 768, hidden_channels: int = 64,
                 num_class: int = 1, dropout_ratio: float = 0.5):
        super().__init__()
        self.num_class = num_class
        self.dropout_ratio = dropout_ratio
        self.fc_hid = nn.Conv3d(in_channels, hidden_channels, 1)
        self.fc_last = nn.Conv3d(hidden_channels, num_class, 1)

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


class IQAHead(_Dropout):
    def __init__(self, in_channels: int = 768, hidden_channels: int = 64,
                 num_class: int = 1, dropout_ratio: float = 0.5):
        super().__init__()
        self.num_class = num_class
        self.dropout_ratio = dropout_ratio
        self.fc_hid = nn.Linear(in_channels, hidden_channels)
        self.fc_last = nn.Linear(hidden_channels, num_class)

    def forward(self, x, gen=None):
        x = F.gelu(self.fc_hid(self._drop(x.to(self.fc_hid.weight.dtype),
                                          gen)))
        x = self.fc_last(self._drop(x, gen))
        if self.num_class > 1:
            x = x.softmax(dim=-1)
        return x.mean(dim=(-3, -2, -1))


class VARHead(_Dropout):
    def __init__(self, in_channels: int = 768, out_channels: int = 400,
                 dropout_ratio: float = 0.5):
        super().__init__()
        self.dropout_ratio = dropout_ratio
        self.fc = nn.Conv3d(in_channels, out_channels, 1)

    def forward(self, x, gen=None):
        # x: (B, T, H, W, C) -> (B, out_channels)
        x = self._drop(x, gen).mean(dim=(1, 2, 3), keepdim=True)
        return conv1x1(self.fc, x).mean(dim=(1, 2, 3))


class MaxVQAHead(_Dropout):
    def __init__(self, in_channels: int = 768,
                 hidden_channels_per_dim: int = 64, out_dims: int = 1,
                 dropout_ratio: float = 0.5):
        super().__init__()
        self.out_dims = out_dims
        self.dropout_ratio = dropout_ratio
        hidden = hidden_channels_per_dim * out_dims
        self.fc_hid = nn.Conv3d(in_channels, hidden, 1)
        self.fc_last = nn.Conv3d(hidden, out_dims, 1, groups=out_dims)

    def forward(self, x, gen=None):
        # x: (B, T, H, W, C) -> (B, out_dims)
        h = F.gelu(conv1x1(self.fc_hid, self._drop(x, gen)))
        h = self._drop(h, gen)
        h = h.reshape(*h.shape[:-1], self.out_dims, -1)
        w = self.fc_last.weight.reshape(self.out_dims, -1).to(h.dtype)
        out = torch.einsum("...gd,gd->...g", h, w)
        return (out + self.fc_last.bias.to(h.dtype)).mean(dim=(1, 2, 3))
