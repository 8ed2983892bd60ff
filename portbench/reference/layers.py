"""Building blocks of the plain reference, channels-last, in float32.

A frozen copy of the port's plain path (``use_pallas: false``) as it stood
when the benchmark was written, so that later changes to the program do
not move the yardstick.  It imports nothing of the program.  Parameter
names are the reference checkpoints' (``weight``, ``bias``), the same as
the program's, so one state dict loads into both.

Every training draw (DropPath, dropout) comes from the generator passed
in, in the program's order, so that a generator seeded as the program's
gives the same masks; a :class:`DrawTape` in its place keeps them for a
batch that is computed again in blocks of rows.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6  # flax.linen.LayerNorm's default, as the program keeps it


def layer_norm(x, weight, bias, eps: float = LN_EPS):
    """flax LayerNorm over the last axis (variance as E[x^2] - E[x]^2)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    mu2 = (xf * xf).mean(-1, keepdim=True)
    var = (mu2 - mu * mu).clamp_min(0.0)
    y = (xf - mu) * (torch.rsqrt(var + eps) * weight.float())
    return (y + bias.float()).to(x.dtype)


def conv_channels_last(conv, x):
    return conv(x.movedim(-1, 1)).movedim(1, -1)


def conv1x1(conv, x):
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


def keep_multipliers(shape, rate: float, gen, device) -> torch.Tensor:
    """float32 ``mask / keep``, mask ~ Bernoulli(1 - rate), from ``gen``
    (a :class:`DrawTape` hands its taped draw instead)."""
    if isinstance(gen, DrawTape):
        return gen.draw(shape, rate, device)
    keep = 1.0 - rate
    mask = torch.rand(shape, generator=gen, device=device) < keep
    return mask.float() / keep


class DrawTape:
    """Stands in for the generator of a forward over a batch of ``batch``
    rows that is computed again in blocks of rows.  Recording, it draws
    each :func:`keep_multipliers` from ``gen`` and keeps it, in order;
    after ``replay(start, stop)`` it hands the same draws back in the
    same order, each sliced on its leading axis to rows ``start:stop``
    (a leading axis of k x ``batch`` holds each row's k in turn), and
    draws nothing.  A draw whose leading axis is not a multiple of
    ``batch`` has no rows to slice and raises."""

    def __init__(self, gen, batch: int):
        self.gen, self.batch = gen, batch
        self.draws: list[torch.Tensor] = []
        self.rows: tuple[int, int] | None = None
        self.at = 0

    def replay(self, start: int, stop: int) -> "DrawTape":
        self.rows, self.at = (start, stop), 0
        return self

    def replayed_all(self) -> bool:
        return self.at == len(self.draws)

    def draw(self, shape, rate: float, device) -> torch.Tensor:
        shape = tuple(shape)
        if self.rows is None:
            if not shape or shape[0] % self.batch:
                raise ValueError(
                    f"a draw of shape {shape} does not lead with the "
                    f"batch's {self.batch} rows: no block of rows can "
                    f"replay it")
            out = keep_multipliers(shape, rate, self.gen, device)
            self.draws.append(out)
            return out
        if self.at == len(self.draws):
            raise ValueError("a block's forward draws more than the "
                             "whole batch's did")
        taped = self.draws[self.at]
        self.at += 1
        k = taped.shape[0] // self.batch
        start, stop = self.rows
        out = taped[start * k:stop * k]
        if tuple(out.shape) != shape:
            raise ValueError(f"a block's forward asks for a draw of shape "
                             f"{shape}; the tape holds {tuple(out.shape)} "
                             f"for its rows")
        return out


def maybe_dropout(x, rate: float, training: bool, gen):
    if not training or rate == 0.0:
        return x
    mult = keep_multipliers(x.shape, rate, gen, x.device)
    return (x.float() * mult).to(x.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, drop: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.drop = drop

    def forward(self, x, gen=None):
        x = maybe_dropout(F.gelu(self.fc1(x)), self.drop, self.training, gen)
        return maybe_dropout(self.fc2(x), self.drop, self.training, gen)


class DropPath(nn.Module):
    """Stochastic depth: the caller draws the (B,) multipliers."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def multipliers(self, batch: int, gen, device):
        if not self.training or self.rate == 0.0:
            return None
        return keep_multipliers((batch,), self.rate, gen, device)

    def forward(self, x, mult=None):
        if mult is None:
            return x
        shape = (-1,) + (1,) * (x.dim() - 1)
        return (x.float() * mult.view(shape)).to(x.dtype)


class PatchEmbed3D(nn.Module):
    """Conv3d with kernel = stride = patch, as space-to-depth and one
    product, then LayerNorm.  ``packed``: the input is already packed in
    the (ti, hi, wi, c) order of the conv kernel."""

    def __init__(self, patch_size=(2, 4, 4), embed_dim: int = 96,
                 in_channels: int = 3):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.proj = nn.Conv3d(in_channels, embed_dim, self.patch_size,
                              stride=self.patch_size)
        self.norm = LayerNorm(embed_dim)

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
        w = self.proj.weight.permute(2, 3, 4, 1, 0).reshape(
            -1, self.proj.weight.shape[0])
        return self.norm(torch.matmul(x, w) + self.proj.bias)


class PatchMerging(nn.Module):
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
    """Mean and unbiased standard deviation over ``axes``."""
    xf = x.float()
    axes = tuple(axes)
    n = 1
    for a in axes:
        n *= x.shape[a]
    mean = xf.mean(dim=axes)
    var = xf.var(dim=axes, unbiased=False) * (n / max(n - 1, 1))
    return mean, torch.sqrt(var + eps)


class VQAHead(nn.Module):
    def __init__(self, in_channels: int = 768, hidden_channels: int = 64,
                 dropout_ratio: float = 0.5):
        super().__init__()
        self.dropout_ratio = dropout_ratio
        self.fc_hid = nn.Conv3d(in_channels, hidden_channels, 1)
        self.fc_last = nn.Conv3d(hidden_channels, 1, 1)

    def tokens(self, x, gen=None):
        """The per-token scores (B, T, H, W, 1) that ``forward`` averages."""
        r, t = self.dropout_ratio, self.training
        x = F.gelu(conv1x1(self.fc_hid, maybe_dropout(x, r, t, gen)))
        return conv1x1(self.fc_last, maybe_dropout(x, r, t, gen))

    def forward(self, x, gen=None):
        return self.tokens(x, gen).mean(dim=(1, 2, 3))
