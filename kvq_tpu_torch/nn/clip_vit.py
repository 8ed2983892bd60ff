"""CLIP ViT-B/16 visual encoder with cls-token adapters — the KSVQE semantic
tool (counterpart of kvq_tpu/nn/clip_vit.py; reference CLIP visual tower,
clip/model.py:252-294, wrapped by CLIP_extractor_addadapter_cls,
CLIP_backbone.py:115-202).

Returns (cls_attn = cosine(cls, patches), cls_token, patch_tokens) from the
raw last block, without ln_post/proj.  Attention is a plain matmul and
softmax, as the JAX package leaves it to XLA.  Parameter names are the
reference's (``visual.transformer.resblocks.{i}.attn.in_proj_weight``, ...;
adapters ``adapter_layer.{i}``).
"""

from __future__ import annotations

import functools
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .cdm import AdapterMLP
from .layers import LayerNorm


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class QuickGELU(nn.Module):
    def forward(self, x):
        return quick_gelu(x)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@functools.lru_cache(maxsize=None)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of jax.image.resize's bicubic (Keys, a=-0.5)
    with antialiasing: the kernel widens by n_in/n_out when downsampling."""
    inv = n_in / n_out
    kscale = max(inv, 1.0)
    sample = (np.arange(n_out, dtype=np.float32) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
    w = _keys_cubic(x / kscale).astype(np.float32)
    tot = w.sum(0, keepdims=True)
    w = np.where(np.abs(tot) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(tot != 0, tot, 1), 0)
    valid = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(valid[None, :], w, 0).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _resize_weights_on(n_in: int, n_out: int,
                       device: torch.device) -> torch.Tensor:
    """:func:`_resize_weights` on ``device``, copied there once: a copy from
    host memory in every forward would make the host wait for the card."""
    return torch.as_tensor(_resize_weights(n_in, n_out), device=device)


def resize_pos_embed_2d(pos_embed, src_grid: int, dst_grid):
    """(1+S*S, C) -> (1+gh*gw, C): bicubic resize of the grid part
    (reference resize_pos_embed2d, CLIP_backbone.py:35-69, computed as
    jax.image.resize computes it)."""
    gh, gw = dst_grid
    if (src_grid, src_grid) == (gh, gw):
        return pos_embed
    grid = pos_embed[1:].float().reshape(src_grid, src_grid, -1)
    wh = _resize_weights_on(src_grid, gh, grid.device)
    ww = _resize_weights_on(src_grid, gw, grid.device)
    grid = torch.einsum("ia,ijc,jb->abc", wh, grid, ww)
    return torch.cat([pos_embed[:1].float(), grid.reshape(gh * gw, -1)]
                     ).to(pos_embed.dtype)


class CLIPAttention(nn.Module):
    """nn.MultiheadAttention's parameters, computed as matmul + softmax."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x, attn_bias=None):
        """``attn_bias``: an additive (N, N) float32 bias of the scores,
        e.g. the text encoder's causal mask."""
        B, N, C = x.shape
        h, hd = self.heads, C // self.heads
        q, k, v = (F.linear(x, self.in_proj_weight, self.in_proj_bias)
                   .reshape(B, N, 3, h, hd).permute(2, 0, 3, 1, 4))
        attn = torch.matmul((q * hd ** -0.5).float(),
                            k.float().transpose(-1, -2))
        if attn_bias is not None:
            attn = attn + attn_bias
        attn = attn.softmax(dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, N, C)
        return self.out_proj(out)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.attn = CLIPAttention(width, heads)
        self.ln_1 = LayerNorm(width)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(width, 4 * width)),
            ("gelu", QuickGELU()),
            ("c_proj", nn.Linear(4 * width, width)),
        ]))
        self.ln_2 = LayerNorm(width)

    def forward(self, x, attn_bias=None):
        x = x + self.attn(self.ln_1(x), attn_bias)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(width, heads) for _ in range(layers)])


class VisualTransformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, patch_size: int,
                 image_grid: int):
        super().__init__()
        self.image_grid = image_grid
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size,
                               bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(
            torch.zeros(1 + image_grid ** 2, width))
        self.ln_pre = LayerNorm(width)
        self.transformer = Transformer(width, layers, heads)

    def tokens(self, x, after_block=None):
        """(B, H, W, 3) CLIP-normalised -> the (B, 1 + L, C) tokens after
        the last block, the class token first; ``after_block(i, x)``, when
        given, replaces the tokens after block ``i``."""
        B = x.shape[0]
        dt = self.conv1.weight.dtype
        x = self.conv1(x.to(dt).permute(0, 3, 1, 2))  # NCHW inside
        gh, gw = x.shape[2], x.shape[3]
        x = x.flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(dt).expand(B, 1, -1)
        x = torch.cat([cls, x], dim=1)
        pe = resize_pos_embed_2d(self.positional_embedding, self.image_grid,
                                 (gh, gw))
        x = self.ln_pre(x + pe.to(dt)[None])
        for i, blk in enumerate(self.transformer.resblocks):
            x = blk(x)
            if after_block is not None:
                x = after_block(i, x)
        return x


class CLIPVisionTower(nn.Module):
    """Input (B, H, W, 3) CLIP-normalised; output (cls_attn (B, L),
    cls_token (B, C), patch_tokens (B, L, C))."""

    def __init__(self, width=768, layers=12, heads=12, patch_size=16,
                 image_grid=14, clip_location=8, cls_use=True,
                 adapter_ratio=0.5):
        super().__init__()
        self.clip_location = clip_location
        self.adapter_ratio = adapter_ratio
        self.visual = VisualTransformer(width, layers, heads, patch_size,
                                        image_grid)
        n_adapters = max(0, layers - clip_location) if cls_use else 0
        self.adapter_layer = nn.ModuleList(
            [AdapterMLP(width, width) for _ in range(n_adapters)])

    def _adapt(self, i, x):
        """The cls-token adapter of block ``i`` (from ``clip_location``)."""
        if i < self.clip_location or not len(self.adapter_layer):
            return x
        a = self.adapter_layer[i - self.clip_location](x[:, :1])
        cls_tok = self.adapter_ratio * a + (1 - self.adapter_ratio) * x[:, :1]
        return torch.cat([cls_tok, x[:, 1:]], dim=1)

    def forward(self, x):
        x = self.visual.tokens(x, self._adapt)
        cls_token, pat_token = x[:, 0], x[:, 1:]
        cf, pf = cls_token.float(), pat_token.float()
        cls_attn = torch.einsum("bc,blc->bl", cf, pf) / (
            cf.norm(dim=-1, keepdim=True) * pf.norm(dim=-1) + 1e-8)
        return cls_attn, cls_token, pat_token
