"""Video Swin Transformer 3D with relative and fragment position biases,
the plain path only (frozen copy of the port's ``use_pallas: false``
route; reference swin_backbone.py of FAST-VQA).

Kept from the reference: the relative-position index is built for the
configured window and sliced ``[:N, :N]`` where a small input clamps the
window; the fragment gate is the unclamped ``sum(|delta fragment id|)``;
tokens padded up to whole windows are not masked.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import nn

from .layers import (
    DropPath,
    LayerNorm,
    Mlp,
    PatchEmbed3D,
    PatchMerging,
    keep_multipliers,
    maybe_dropout,
)


def get_window_size(x_size, window_size, shift_size):
    use_window, use_shift = list(window_size), list(shift_size)
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            use_window[i] = x_size[i]
            use_shift[i] = 0
    return tuple(use_window), tuple(use_shift)


@functools.lru_cache(maxsize=None)
def relative_position_index(window_size: tuple[int, int, int]) -> np.ndarray:
    wd, wh, ww = window_size
    coords = np.stack(np.meshgrid(np.arange(wd), np.arange(wh),
                                  np.arange(ww), indexing="ij")).reshape(3, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wd - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= 2 * ww - 1
    return rel.sum(-1)


def expand_bias_planes(table, table_window, n):
    """(table_len, h) -> (h, n, n) through the relative-position gather."""
    rpi = relative_position_index(tuple(table_window))[:n, :n]
    idx = torch.as_tensor(rpi.reshape(-1), device=table.device)
    return table.float().index_select(0, idx).view(n, n, -1).permute(2, 0, 1)


def window_partition(x, window):
    B, D, H, W, C = x.shape
    wd, wh, ww = window
    x = x.reshape(B, D // wd, wd, H // wh, wh, W // ww, ww, C)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(B, -1, wd * wh * ww, C)


def window_reverse(windows, window, B, D, H, W):
    wd, wh, ww = window
    x = windows.reshape(B, D // wd, H // wh, W // ww, wd, wh, ww, -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, D, H, W, -1)


def gate_and_mask(dims, window, shift, fragments, device):
    """(nW, N, N) fragment gate and additive seam mask (None unshifted) of
    a padded token volume ``dims``: each token's fragment id is taken at
    its pre-roll coordinate, its seam segment in the rolled frame."""
    wd, wh, ww = window
    n = wd * wh * ww
    tok = np.arange(n)
    offs = (tok // (wh * ww), (tok // ww) % wh, tok % ww)
    fids, segs = [], []
    for ax in range(3):
        dim, w, s, f = dims[ax], window[ax], shift[ax], fragments[ax]
        g = np.arange(dim // w)[:, None] * w + offs[ax][None, :]
        fids.append(((g + s) % dim) * f // dim)
        segs.append(np.where(g < dim - w, 0, np.where(g < dim - s, 1, 2)))
    gd, gh, gw = (a.shape[0] for a in fids)
    fid = np.stack(np.broadcast_arrays(
        fids[0].reshape(gd, 1, 1, n), fids[1].reshape(1, gh, 1, n),
        fids[2].reshape(1, 1, gw, n)), axis=-1).reshape(-1, n, 3)
    fid = torch.as_tensor(fid, device=device, dtype=torch.float32)
    gate = sum((fid[:, :, None, a] - fid[:, None, :, a]).abs()
               for a in range(3))
    mask = None
    if any(shift):
        sd, sh, sw = segs
        seg = (sd[:, None, None, :] * 9 + sh[None, :, None, :] * 3
               + sw[None, None, :, :]).reshape(-1, n)
        seg = torch.as_tensor(seg, device=device)
        mask = torch.where(seg[:, :, None] != seg[:, None, :], -100.0, 0.0)
    return gate, mask


def _table_len(window):
    wd, wh, ww = window
    return (2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1)


class WindowAttention3D(nn.Module):
    def __init__(self, dim, num_heads, table_window, frag_bias=False,
                 qkv_bias=True, attn_drop=0.0, proj_drop=0.0):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.table_window = tuple(table_window)
        self.frag_bias = frag_bias
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        n = _table_len(self.table_window)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(n, num_heads))
        if frag_bias:
            self.fragment_position_bias_table = nn.Parameter(
                torch.zeros(n, num_heads))

    def forward(self, x, mask=None, gate=None, gen=None):
        # x: (B, nW, N, C); mask, gate: (nW, N, N) or None
        B, nW, N, C = x.shape
        h = self.num_heads
        hd = C // h
        q, k, v = (self.qkv(x).view(B, nW, N, 3, h, hd)
                   .permute(3, 0, 1, 4, 2, 5))
        rel = expand_bias_planes(self.relative_position_bias_table,
                                 self.table_window, N)
        attn = torch.matmul(q * hd ** -0.5, k.transpose(-1, -2))
        if self.frag_bias and gate is not None:
            frag = expand_bias_planes(self.fragment_position_bias_table,
                                      self.table_window, N)
            g = gate[:, None]
            attn = attn + (rel[None] * g + frag[None] * (1.0 - g))
        else:
            attn = attn + rel[None]
        if mask is not None:
            attn = attn + mask[:, None]
        p = attn.softmax(dim=-1)
        if self.training and self.attn_drop > 0.0:
            p = p * keep_multipliers(p.shape, self.attn_drop, gen, p.device)
        out = torch.matmul(p, v).transpose(2, 3).reshape(B, nW, N, C)
        return maybe_dropout(self.proj(out), self.proj_drop, self.training,
                             gen)


class SwinBlock3D(nn.Module):
    def __init__(self, dim, num_heads, window_size, shift, mlp_ratio=4.0,
                 qkv_bias=True, drop_path=0.0, frag_bias=False,
                 fragments_hw=7, drop=0.0, attn_drop=0.0):
        super().__init__()
        self.window_size = tuple(window_size)
        self.shift = shift
        self.frag_bias = frag_bias
        self.fragments_hw = fragments_hw
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention3D(dim, num_heads, window_size,
                                      frag_bias=frag_bias, qkv_bias=qkv_bias,
                                      attn_drop=attn_drop, proj_drop=drop)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop)

    def forward(self, x, gen=None, dp=(None, None)):
        B, D, H, W, C = x.shape
        cfg_shift = (tuple(w // 2 for w in self.window_size) if self.shift
                     else (0, 0, 0))
        window, shift = get_window_size((D, H, W), self.window_size,
                                        cfg_shift)
        x = x + self.drop_path(self._attention(x, window, shift, gen), dp[0])
        return x + self.drop_path(self.mlp(self.norm2(x), gen), dp[1])

    def _attention(self, x, window, shift, gen):
        B, D, H, W, C = x.shape
        y = self.norm1(x)
        pads = [(w - d % w) % w for d, w in zip((D, H, W), window)]
        if any(pads):
            y = nn.functional.pad(y, (0, 0, 0, pads[2], 0, pads[1], 0,
                                      pads[0]))
        Dp, Hp, Wp = D + pads[0], H + pads[1], W + pads[2]
        if any(shift):
            y = torch.roll(y, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
        gate, mask = gate_and_mask(
            (Dp, Hp, Wp), window, shift,
            (1, self.fragments_hw, self.fragments_hw), x.device)
        y = self.attn(window_partition(y, window), mask,
                      gate if self.frag_bias else None, gen)
        y = window_reverse(y, window, B, Dp, Hp, Wp)
        if any(shift):
            y = torch.roll(y, shifts=tuple(shift), dims=(1, 2, 3))
        return y[:, :D, :H, :W] if any(pads) else y


class BasicLayer(nn.Module):
    """``depth`` blocks of alternating shift, then PatchMerging.  Each
    block's two DropPath multiplier sets are drawn before the block, as
    the program draws them."""

    def __init__(self, dim, depth, num_heads, window_size, drop_paths,
                 downsample, frag_bias, fragments_hw=7, mlp_ratio=4.0,
                 qkv_bias=True, drop=0.0, attn_drop=0.0):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock3D(dim, num_heads, window_size, shift=i % 2 == 1,
                        mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                        drop_path=drop_paths[i], frag_bias=frag_bias,
                        fragments_hw=fragments_hw, drop=drop,
                        attn_drop=attn_drop)
            for i in range(depth)])
        self.downsample = PatchMerging(dim) if downsample else None

    def forward(self, x, gen=None):
        for blk in self.blocks:
            B = x.shape[0]
            dp = (blk.drop_path.multipliers(B, gen, x.device),
                  blk.drop_path.multipliers(B, gen, x.device))
            x = blk(x, gen, dp)
        return x if self.downsample is None else self.downsample(x)


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    patch_size: tuple[int, int, int] = (2, 4, 4)
    embed_dim: int = 96
    depths: tuple[int, ...] = (2, 2, 6, 2)
    num_heads: tuple[int, ...] = (3, 6, 12, 24)
    window_size: tuple[int, int, int] = (8, 7, 7)
    mlp_ratio: float = 4.0
    drop_path_rate: float = 0.1
    frag_biases: tuple[bool, ...] = (True, True, True, False)
    fragments_hw: int = 7


PRESETS = {  # FAST-VQA's model keys (reference models/model.py:30-47)
    "swin_tiny": dict(frag_biases=(False,) * 4),
    "swin_tiny_grpb": dict(),
    "swin_tiny_grpb_m": dict(window_size=(4, 4, 4), frag_biases=(False,) * 4),
}


def make_stages(cfg: SwinConfig) -> nn.ModuleList:
    dpr = np.linspace(0, cfg.drop_path_rate, sum(cfg.depths))
    stages = []
    for i, depth in enumerate(cfg.depths):
        start = sum(cfg.depths[:i])
        stages.append(BasicLayer(
            dim=int(cfg.embed_dim * 2 ** i), depth=depth,
            num_heads=cfg.num_heads[i], window_size=cfg.window_size,
            drop_paths=tuple(float(d) for d in dpr[start:start + depth]),
            downsample=i < len(cfg.depths) - 1,
            frag_bias=bool(cfg.frag_biases[i]),
            fragments_hw=cfg.fragments_hw, mlp_ratio=cfg.mlp_ratio))
    return nn.ModuleList(stages)


class SwinTransformer3D(nn.Module):
    """Patch embed + stages + LayerNorm over ``batch["technical"]``."""

    def __init__(self, config: SwinConfig):
        super().__init__()
        self.patch_embed = PatchEmbed3D(config.patch_size, config.embed_dim)
        self.layers = make_stages(config)
        self.num_features = int(config.embed_dim
                                * 2 ** (len(config.depths) - 1))
        self.norm = LayerNorm(self.num_features)

    def forward(self, batch, gen=None):
        x = self.patch_embed(batch["technical"].float())
        for stage in self.layers:
            x = stage(x, gen)
        return self.norm(x)
