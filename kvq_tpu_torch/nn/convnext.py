"""ConvNeXt-3D, the backbone of the ``conv_tiny`` model key, and the per-image
ConvNeXt (counterpart of kvq_tpu/nn/convnext.py; reference ConvNeXt3D,
conv_backbone.py:347-434, an inflated copy of upstream ConvNeXt).

  - stem: a (patch_t, 4, 4) conv of that stride, then LayerNorm; each later
    stage starts with a LayerNorm and a (1, 2, 2) conv of that stride;
  - :class:`Block3D`: a depthwise (k, 7, 7) conv, k cycled through
    ``inflate_strategy`` ("131": 1, 3, 1, ...) by block index -> LayerNorm
    (eps 1e-6) -> Linear to 4x -> exact GELU -> :class:`GRN` (V2 only) ->
    Linear back -> a layer scale (not V2) -> DropPath, added to the input;
  - a final LayerNorm; the network returns the (B, T', H', W', C) volume
    (the reference's ``return_spatial``), which the VQAHead pools.

Channels-last (B, T, H, W, C), as the JAX package keeps it.  The stem and
downsample convs see the volume permuted to (B, C, T, H, W), a view in
PyTorch's channels_last_3d layout, with no copy around them; the depthwise
conv is ``F.conv3d`` with ``groups=C``, as the JAX package leaves it to
XLA, on a contiguous copy (:func:`conv_cl`).  Parameter names
are upstream ConvNeXt's (``downsample_layers.{i}.{0,1}``,
``stages.{i}.{j}.{dwconv,norm,pwconv1,pwconv2,gamma,grn}``, ``norm``);
the layer scale and GRN's ``gamma``/``beta`` are (C,) vectors.

:class:`ConvNeXt3D` reads ``batch["asesthetic"]`` [sic], the reference's
key (conv_backbone.py:432), as kvq_tpu does.  :class:`GRN` follows
kvq_tpu: the sum of squares over (T, H, W) in float32, ``sqrt(. + 1e-12)``,
divided by its channel mean ``+ 1e-6``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import DropPath, LayerNorm


def conv_cl(conv: nn.Conv3d, x):
    """``conv`` on a channels-last (B, T, H, W, C) volume.  A depthwise
    conv takes the volume copied to contiguous (B, C, T, H, W) and back:
    on a channels_last_3d input cuDNN runs it channel by channel (two
    kernel launches a channel), on a contiguous one PyTorch's own
    depthwise kernel runs once (chip_smoke.py's two-branch phase times
    both)."""
    y = x.permute(0, 4, 1, 2, 3)
    if conv.groups > 1:
        y = y.contiguous()
    y = F.conv3d(y, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                 conv.stride, conv.padding, conv.dilation, conv.groups)
    y = y.permute(0, 2, 3, 4, 1)
    return y.contiguous() if conv.groups > 1 else y


class GRN(nn.Module):
    """Global response normalisation (ConvNeXt-V2, conv_backbone.py:7-18)."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        gx = torch.sqrt(x.float().square().sum(dim=(-4, -3, -2), keepdim=True)
                        + 1e-12)
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        y = self.gamma * (x * nx.to(x.dtype)) + self.beta + x
        return y.to(x.dtype)


class Block3D(nn.Module):
    def __init__(self, dim: int, inflate_len: int = 3, drop_path: float = 0.0,
                 layer_scale_init: float = 1e-6, v2: bool = False):
        super().__init__()
        k = inflate_len
        self.dwconv = nn.Conv3d(dim, dim, (k, 7, 7), padding=(k // 2, 3, 3),
                                groups=dim)
        self.norm = LayerNorm(dim)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.grn = GRN(4 * dim) if v2 else None
        self.gamma = (nn.Parameter(torch.full((dim,), layer_scale_init))
                      if not v2 and layer_scale_init > 0 else None)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, gen=None):
        y = self.norm(conv_cl(self.dwconv, x))
        y = F.gelu(self.pwconv1(y))
        if self.grn is not None:
            y = self.grn(y)
        y = self.pwconv2(y)
        if self.gamma is not None:
            y = self.gamma.to(y.dtype) * y
        mult = self.drop_path.multipliers(x.shape[0], gen, x.device)
        return x + self.drop_path(y, mult)


class ConvNeXt3D(nn.Module):
    def __init__(self, depths=(3, 3, 9, 3), dims=(96, 192, 384, 768),
                 inflate_strategy: str = "131", patch_t: int = 2,
                 drop_path_rate: float = 0.0, v2: bool = False,
                 input_key: str = "asesthetic", in_channels: int = 3):
        super().__init__()
        self.input_key = input_key
        self.num_features = dims[-1]
        self.downsample_layers = nn.ModuleList([nn.Sequential(
            nn.Conv3d(in_channels, dims[0], (patch_t, 4, 4),
                      stride=(patch_t, 4, 4)),
            LayerNorm(dims[0]))])
        for i in range(1, len(depths)):
            self.downsample_layers.append(nn.Sequential(
                LayerNorm(dims[i - 1]),
                nn.Conv3d(dims[i - 1], dims[i], (1, 2, 2), stride=(1, 2, 2))))
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        self.stages = nn.ModuleList()
        cur = 0
        for i, depth in enumerate(depths):
            ks = [int(inflate_strategy[j % len(inflate_strategy)])
                  for j in range(depth)]
            self.stages.append(nn.Sequential(*(
                Block3D(dims[i], k, float(dpr[cur + j]), v2=v2)
                for j, k in enumerate(ks))))
            cur += depth
        self.norm = LayerNorm(dims[-1])

    def forward(self, batch, gen=None):
        """``gen``: the torch.Generator of a training forward's DropPath
        draws (one per block, in block order)."""
        x = batch[self.input_key] if isinstance(batch, dict) else batch
        x = x.to(self.norm.weight.dtype)
        for i, (down, stage) in enumerate(zip(self.downsample_layers,
                                              self.stages)):
            if i == 0:
                x = down[1](conv_cl(down[0], x))
            else:
                x = conv_cl(down[1], down[0](x))
            for blk in stage:
                x = blk(x, gen)
        return self.norm(x)


class ConvNeXt2D(nn.Module):
    """The per-image ConvNeXt (reference 2D variants, conv_backbone.py:
    265-340, 542-583): the 3D network at patch_t 1 and temporal kernels of
    1 (``trunk``), which is the 2D network applied to each frame.  Takes
    (B, H, W, C) or (B, T, H, W, C)."""

    def __init__(self, depths=(3, 3, 9, 3), dims=(96, 192, 384, 768),
                 drop_path_rate: float = 0.0, v2: bool = False):
        super().__init__()
        self.trunk = ConvNeXt3D(depths, dims, inflate_strategy="1", patch_t=1,
                                drop_path_rate=drop_path_rate, v2=v2)
        self.num_features = dims[-1]

    def forward(self, x, gen=None):
        if x.dim() == 4:
            return self.trunk(x[:, None], gen)[:, 0]
        return self.trunk(x, gen)


_TINY = ((3, 3, 9, 3), (96, 192, 384, 768))
_SMALL = ((3, 3, 27, 3), (96, 192, 384, 768))
_BASE = ((3, 3, 27, 3), (128, 256, 512, 1024))
_LARGE = ((3, 3, 27, 3), (192, 384, 768, 1536))
_XLARGE = ((3, 3, 27, 3), (256, 512, 1024, 2048))
_HUGE = ((3, 3, 27, 3), (352, 704, 1408, 2816))
_ATTO = ((2, 2, 6, 2), (40, 80, 160, 320))
_FEMTO = ((2, 2, 6, 2), (48, 96, 192, 384))
_PICO = ((2, 2, 6, 2), (64, 128, 256, 512))
_NANO = ((2, 2, 8, 2), (80, 160, 320, 640))


def _3d(size, v2=False):
    return lambda **kw: ConvNeXt3D(*size, v2=v2, **kw)


def _2d(size, v2=False):
    return lambda **kw: ConvNeXt2D(*size, v2=v2, **kw)


# the factories of kvq_tpu/nn/convnext.py, each taking the class's keywords
convnext_3d_tiny = _3d(_TINY)
convnext_3d_small = _3d(_SMALL)
convnext_3d_base = _3d(_BASE)
convnext_3d_large = _3d(_LARGE)
convnext_3d_xlarge = _3d(_XLARGE)
convnextv2_3d_atto = _3d(_ATTO, v2=True)
convnextv2_3d_femto = _3d(_FEMTO, v2=True)
convnextv2_3d_pico = _3d(_PICO, v2=True)
convnextv2_3d_nano = _3d(_NANO, v2=True)
convnextv2_3d_tiny = _3d(_TINY, v2=True)
convnextv2_3d_base = _3d(_BASE, v2=True)
convnextv2_3d_large = _3d(_LARGE, v2=True)
convnextv2_3d_huge = _3d(_HUGE, v2=True)
convnext_tiny = _2d(_TINY)
convnext_small = _2d(_SMALL)
convnext_base = _2d(_BASE)
convnext_large = _2d(_LARGE)
convnext_xlarge = _2d(_XLARGE)
convnext_pico = _2d(_PICO)
convnextv2_atto = _2d(_ATTO, v2=True)
convnextv2_femto = _2d(_FEMTO, v2=True)
convnextv2_nano = _2d(_NANO, v2=True)
convnextv2_tiny = _2d(_TINY, v2=True)
convnextv2_base = _2d(_BASE, v2=True)
convnextv2_large = _2d(_LARGE, v2=True)
convnextv2_huge = _2d(_HUGE, v2=True)
