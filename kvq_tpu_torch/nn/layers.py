"""Common building blocks, channels-last (counterparts of kvq_tpu/nn/layers.py).

Parameter names follow the PyTorch reference checkpoints (``weight``,
``bias``), so reference state dicts load with ``load_state_dict``.

LayerNorm: the JAX package uses flax's LayerNorm, whose epsilon is 1e-6 and
whose variance is ``mean(x^2) - mean(x)^2`` in float32; torch's default
epsilon is 1e-5.  :func:`layer_norm` reproduces flax's formula with eps
1e-6 everywhere the JAX package relies on flax's default.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6  # flax.linen.LayerNorm default


def layer_norm(x, weight, bias, eps: float = LN_EPS):
    """flax LayerNorm over the last axis: float32 statistics, fast
    variance, output in x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    mu2 = (xf * xf).mean(-1, keepdim=True)
    var = (mu2 - mu * mu).clamp_min(0.0)
    y = (xf - mu) * (torch.rsqrt(var + eps) * weight.float())
    return (y + bias.float()).to(x.dtype)


def conv_channels_last(conv, x):
    """A 2-D or 3-D conv module on a channels-last tensor (N, ..., C)."""
    return conv(x.movedim(-1, 1)).movedim(1, -1)


def conv1x1(conv, x):
    """A 1x1(x1) Conv applied channels-last as a matmul (x: (..., C_in))."""
    w = conv.weight.reshape(conv.weight.shape[0], -1)
    return F.linear(x, w.to(x.dtype), conv.bias.to(x.dtype))


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = LN_EPS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> dropout -> fc2 -> dropout (reference
    swin_backbone.py:64-91); the dropouts (rate ``drop``) in training
    only, drawn from ``gen``."""

    def __init__(self, dim: int, hidden: int, drop: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.drop = drop

    def forward(self, x, gen=None):
        x = maybe_dropout(F.gelu(self.fc1(x)), self.drop, self.training, gen)
        return maybe_dropout(self.fc2(x), self.drop, self.training, gen)


def keep_multipliers(shape, rate: float, gen, device) -> torch.Tensor:
    """float32 multipliers ``mask / keep`` with mask ~ Bernoulli(keep),
    keep = 1 - rate, drawn from ``gen``: the training draws of DropPath and
    dropout.  Every draw of the train path comes from one explicit
    generator, in a fixed order, whichever route runs."""
    if gen is None:
        raise ValueError("a training forward draws from a torch.Generator: "
                         "pass gen")
    keep = 1.0 - rate
    mask = torch.rand(shape, generator=gen, device=device) < keep
    return mask.float() / keep


def dropout(x, rate: float, gen):
    """Elementwise dropout (flax ``nn.Dropout``): x / keep where kept, else
    0."""
    mult = keep_multipliers(x.shape, rate, gen, x.device)
    return (x.float() * mult).to(x.dtype)


def maybe_dropout(x, rate: float, training: bool, gen):
    """:func:`dropout` in training at a rate above 0, else ``x``."""
    if not training or rate == 0.0:
        return x
    return dropout(x, rate, gen)


class DropPath(nn.Module):
    """Stochastic depth (reference timm DropPath; JAX nn/layers.py
    DropPath): in training each sample's residual branch is kept with
    probability 1 - rate and scaled by 1 / (1 - rate).  The caller draws
    the per-sample multipliers with :meth:`multipliers` and applies them
    with ``forward``, so that the fused block kernel can take the same
    draws."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def multipliers(self, batch: int, gen, device):
        """(batch,) float32 mask / keep, or None when nothing is dropped
        (eval, or rate 0)."""
        if not self.training or self.rate == 0.0:
            return None
        return keep_multipliers((batch,), self.rate, gen, device)

    def forward(self, x, mult=None):
        if mult is None:
            return x
        shape = (-1,) + (1,) * (x.dim() - 1)
        return (x.float() * mult.view(shape)).to(x.dtype)


class PatchEmbed3D(nn.Module):
    """Conv3d k=stride=patch as space-to-depth + one matmul, then LayerNorm.
    ``packed=True`` takes the host's s2d-packed fragment
    (data/fragments.py:s2d_pack), (B, T/pt, H/ph, W/pw, pt*ph*pw*C), whose
    (ti, hi, wi, c) flatten order is the conv kernel's."""

    def __init__(self, patch_size=(2, 4, 4), embed_dim: int = 96,
                 in_channels: int = 3):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.proj = nn.Conv3d(in_channels, embed_dim, self.patch_size,
                              stride=self.patch_size)
        self.norm = LayerNorm(embed_dim)

    def _matmul(self, x):
        w = self.proj.weight.permute(2, 3, 4, 1, 0).reshape(
            -1, self.proj.weight.shape[0]
        )
        return torch.matmul(x, w.to(x.dtype)) + self.proj.bias.to(x.dtype)

    def forward(self, x, packed: bool = False):
        pt, ph, pw = self.patch_size
        if not packed:
            B, T, H, W, C = x.shape
            pads = [(p - d % p) % p for d, p in ((T, pt), (H, ph), (W, pw))]
            if any(pads):
                x = F.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
                B, T, H, W, C = x.shape
            x = (x.reshape(B, T // pt, pt, H // ph, ph, W // pw, pw, C)
                 .permute(0, 1, 3, 5, 2, 4, 6, 7)
                 .reshape(B, T // pt, H // ph, W // pw, pt * ph * pw * C))
        return self.norm(self._matmul(x))


class PatchMerging(nn.Module):
    """2x2 spatial merge + LayerNorm + Linear 4C -> 2C
    (reference swin_backbone.py:519-555).  Input (B, T, H, W, C)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        B, T, H, W, C = x.shape
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                       x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


def avg_std_pool(x, axes: Sequence[int], eps: float = 1e-10):
    """Global mean and unbiased standard deviation over ``axes`` (float32)."""
    xf = x.float()
    axes = tuple(axes)
    n = 1
    for a in axes:
        n *= x.shape[a]
    mean = xf.mean(dim=axes)
    var = xf.var(dim=axes, unbiased=False) * (n / max(n - 1, 1))
    return mean, torch.sqrt(var + eps)
