"""Video Swin Transformer 3D with relative + fragment position biases
(counterpart of kvq_tpu/nn/swin.py; reference swin_backbone.py:92-1107).

Reference quirks kept for checkpoint parity:
  - the relative-position index table is built for the *config* window and
    sliced ``[:N, :N]`` when the effective window is clamped by a small
    input (swin_backbone.py:264-266);
  - the fragment gate is ``sum(|Δ fragment id|)``, unclamped, so it scales
    the relative bias for windows spanning more than one fragment
    (swin_backbone.py:291-302).

Routing in :class:`SwinBlock3D` with ``use_pallas`` follows the reference
(nn/reference_routing.py).  At eval, pad-free dims that pass the
reference's gate go through K1
(:func:`~kvq_tpu_torch.ops.window_attention.fused_swin_block`); every other
block (token volumes that pad to the window) runs its plain LayerNorm/MLP
around K3 (:func:`~kvq_tpu_torch.ops.window_attention.
flash_window_attention_packed`) at the padded geometry.  In training,
pad-free blocks that pass both of the reference's gates take K4
(:func:`~kvq_tpu_torch.ops.train_attention.train_swin_block`), and every
other block runs its plain LayerNorm/MLP around K5
(:func:`~kvq_tpu_torch.ops.train_attention.window_attention_train`).  Each
wrapper launches its CUDA kernels for CUDA tensors and runs its plain
version for CPU tensors.  The bias tables get their gradients through the
gather of :func:`expand_bias_planes`.

:class:`SwinTransformer3D` is the whole Video-Swin trunk of the model keys
``swin_tiny``, ``swin_tiny_grpb``, ``swin_tiny_grpb_m`` and ``swin_small``
(presets in :func:`swin_config`).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import nn

from ..ops.train_attention import train_swin_block, window_attention_train
from ..ops.window_attention import (
    WindowGeometry,
    flash_window_attention_packed,
    fused_swin_block,
    gate_and_mask,
    window_attention_plain,
)
from .layers import DropPath, LayerNorm, Mlp, PatchEmbed3D, PatchMerging
from .reference_routing import takes_fused_block


def get_window_size(x_size, window_size, shift_size=None):
    """Clamp window (and zero shift) on dims where input <= window
    (reference swin_backbone.py:145-158)."""
    use_window = list(window_size)
    use_shift = list(shift_size) if shift_size is not None else None
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            use_window[i] = x_size[i]
            if use_shift is not None:
                use_shift[i] = 0
    if use_shift is None:
        return tuple(use_window)
    return tuple(use_window), tuple(use_shift)


@functools.lru_cache(maxsize=None)
def relative_position_index(window_size: tuple[int, int, int]) -> np.ndarray:
    """(N, N) gather indices into the (2Wd-1)(2Wh-1)(2Ww-1) bias table
    (reference swin_backbone.py:212-238)."""
    wd, wh, ww = window_size
    coords = np.stack(
        np.meshgrid(np.arange(wd), np.arange(wh), np.arange(ww), indexing="ij")
    ).reshape(3, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += wd - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= 2 * ww - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=64)
def _rpi_tensor(table_window, n, device):
    rpi = relative_position_index(tuple(table_window))[:n, :n]
    return torch.as_tensor(rpi.reshape(-1), device=device)


def expand_bias_planes(table, table_window, n):
    """(table_len, h) bias table -> (h, n, n) float32 planes through the
    relative-position gather, with the reference's [:N, :N] slice."""
    idx = _rpi_tensor(tuple(table_window), n, table.device)
    planes = table.float().index_select(0, idx)  # backward: index_add_
    return planes.view(n, n, -1).permute(2, 0, 1).contiguous()


def window_partition(x, window_size):
    """(B, D, H, W, C) -> (B, nW, N, C)."""
    B, D, H, W, C = x.shape
    wd, wh, ww = window_size
    x = x.reshape(B, D // wd, wd, H // wh, wh, W // ww, ww, C)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(B, -1, wd * wh * ww, C)


def window_reverse(windows, window_size, B, D, H, W):
    wd, wh, ww = window_size
    x = windows.reshape(B, D // wd, H // wh, W // ww, wd, wh, ww, -1)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, D, H, W, -1)


def _table_len(window):
    wd, wh, ww = window
    return (2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1)


class WindowAttention3D(nn.Module):
    """W-MSA over flattened windows with dual position-bias tables: the
    plain (XLA-composition) path, or, given the padded window geometry, K3
    at eval and K5 in training."""

    def __init__(self, dim, num_heads, table_window, frag_bias=False,
                 qkv_bias=True):
        super().__init__()
        self.num_heads = num_heads
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

    def bias_planes(self, n):
        rel = expand_bias_planes(self.relative_position_bias_table,
                                 self.table_window, n)
        frag = None
        if self.frag_bias:
            frag = expand_bias_planes(self.fragment_position_bias_table,
                                      self.table_window, n)
        return rel, frag

    def forward(self, x, mask=None, fgate=None, geometry=None):
        # x: (B, nW, N, C); mask/fgate: (nW, N, N) or None; geometry: the
        # padded window geometry, given for K3 (eval) or K5 (training)
        B, nW, N, C = x.shape
        h = self.num_heads
        hd = C // h
        rel, frag = self.bias_planes(N)
        if geometry is not None and not self.training:
            out = flash_window_attention_packed(
                self.qkv(x).view(B * nW, N, 3 * C), rel, frag, geometry,
                hd ** -0.5)
            return self.proj(out.view(B, nW, N, C))
        qkv = self.qkv(x).view(B, nW, N, 3, h, hd).permute(3, 0, 1, 4, 2, 5)
        if geometry is not None:
            q, k, v = (t.reshape(B * nW, h, N, hd).contiguous() for t in qkv)
            out = window_attention_train(q, k, v, rel, frag, geometry,
                                         hd ** -0.5).view(B, nW, h, N, hd)
        else:
            out = window_attention_plain(qkv[0], qkv[1], qkv[2], rel, frag,
                                         fgate, mask, hd ** -0.5)
        out = out.transpose(2, 3).reshape(B, nW, N, C).to(x.dtype)
        return self.proj(out)


class SwinBlock3D(nn.Module):
    """One (S)W-MSA + MLP block (reference SwinTransformerBlock3D,
    swin_backbone.py:329-520)."""

    def __init__(self, dim, num_heads, window_size, shift, mlp_ratio=4.0,
                 qkv_bias=True, drop_path=0.0, frag_bias=False,
                 fragments_hw=7, use_pallas=False):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = tuple(window_size)
        self.shift = shift
        self.frag_bias = frag_bias
        self.fragments_hw = fragments_hw
        self.use_pallas = use_pallas
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention3D(dim, num_heads, window_size,
                                      frag_bias=frag_bias, qkv_bias=qkv_bias)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def _geometry(self, B, dims, window, shift, C):
        return WindowGeometry(
            batch=B, dims=tuple(dims), window=window, shift=shift,
            fragments=(1, self.fragments_hw, self.fragments_hw),
            num_heads=self.num_heads, head_dim=C // self.num_heads,
            use_frag=self.frag_bias,
        )

    def block_params(self):
        """The block's weights under K1's keys."""
        a, m = self.attn, self.mlp
        qkv_b = a.qkv.bias
        if qkv_b is None:
            qkv_b = a.qkv.weight.new_zeros(a.qkv.weight.shape[0])
        return {
            "norm1_scale": self.norm1.weight, "norm1_bias": self.norm1.bias,
            "qkv_w": a.qkv.weight, "qkv_b": qkv_b,
            "proj_w": a.proj.weight, "proj_b": a.proj.bias,
            "norm2_scale": self.norm2.weight, "norm2_bias": self.norm2.bias,
            "fc1_w": m.fc1.weight, "fc1_b": m.fc1.bias,
            "fc2_w": m.fc2.weight, "fc2_b": m.fc2.bias,
        }

    def _fused_block(self, x, window, shift, dp1=None, dp2=None):
        """K1 at eval, K4 in training (with the (B,) DropPath multipliers,
        repeated over each sample's windows; ones when nothing drops)."""
        B, D, H, W, C = x.shape
        N = window[0] * window[1] * window[2]
        rel, frag = self.attn.bias_planes(N)
        geo = self._geometry(B, (D, H, W), window, shift, C)
        y = x
        if any(shift):
            y = torch.roll(y, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
        y = window_partition(y, window)
        nW = y.shape[1]
        y = y.reshape(B * nW, N, C).contiguous()
        if self.training:
            ones = torch.ones(B, device=x.device)
            dp1, dp2 = (ones if d is None else d for d in (dp1, dp2))
            out = train_swin_block(y, self.block_params(), rel, frag, geo,
                                   dp1.repeat_interleave(nW),
                                   dp2.repeat_interleave(nW))
        else:
            out = fused_swin_block(y, self.block_params(), rel, frag, geo)
        out = window_reverse(out.reshape(B, nW, N, C), window, B, D, H, W)
        if any(shift):
            out = torch.roll(out, shifts=tuple(shift), dims=(1, 2, 3))
        return out

    def forward(self, x, gen=None):
        """``gen``: the torch.Generator of a training forward's DropPath
        draws (two per block, attention branch first, on every route)."""
        B, D, H, W, C = x.shape
        cfg_shift = (tuple(w // 2 for w in self.window_size) if self.shift
                     else (0, 0, 0))
        window, shift = get_window_size((D, H, W), self.window_size, cfg_shift)
        no_pad = all(d % w == 0 for d, w in zip((D, H, W), window))
        dp1 = self.drop_path.multipliers(B, gen, x.device)
        dp2 = self.drop_path.multipliers(B, gen, x.device)
        if self.use_pallas and no_pad:
            # the gate is decided on the unpadded dims, as the reference's
            probe = self._geometry(B, (D, H, W), window, shift, C)
            if takes_fused_block(probe, C, self.mlp.fc1.out_features,
                                 self.training):
                return self._fused_block(x, window, shift, dp1, dp2)
        x = x + self.drop_path(self._attention(x, window, shift), dp1)
        return x + self.drop_path(self.mlp(self.norm2(x)), dp2)

    def _attention(self, x, window, shift):
        """The attention branch: norm1, zero padding to whole windows (the
        padded tokens are not masked), roll, partition, and W-MSA at the
        padded geometry — K3 at eval and K5 in training with
        ``use_pallas``, else the plain path — then back."""
        B, D, H, W, C = x.shape
        y = self.norm1(x)
        pads = [(w - d % w) % w for d, w in zip((D, H, W), window)]
        if any(pads):
            y = nn.functional.pad(y, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        Dp, Hp, Wp = D + pads[0], H + pads[1], W + pads[2]
        if any(shift):
            y = torch.roll(y, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
        geo = self._geometry(B, (Dp, Hp, Wp), window, shift, C)
        y = window_partition(y, window)
        if self.use_pallas:
            y = self.attn(y, geometry=geo)
        else:
            gate, mask = gate_and_mask(geo, x.device)
            y = self.attn(y, mask, gate if self.frag_bias else None)
        y = window_reverse(y, window, B, Dp, Hp, Wp)
        if any(shift):
            y = torch.roll(y, shifts=tuple(shift), dims=(1, 2, 3))
        if any(pads):
            y = y[:, :D, :H, :W]
        return y


class BasicLayer(nn.Module):
    """One stage: ``depth`` blocks (alternating shift) + optional
    PatchMerging (reference swin_backbone.py:585-667)."""

    def __init__(self, dim, depth, num_heads, window_size, mlp_ratio=4.0,
                 qkv_bias=True, drop_paths=(), downsample=True,
                 frag_bias=False, fragments_hw=7, use_pallas=False):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock3D(dim, num_heads, window_size, shift=i % 2 == 1,
                        mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                        drop_path=drop_paths[i] if drop_paths else 0.0,
                        frag_bias=frag_bias, fragments_hw=fragments_hw,
                        use_pallas=use_pallas)
            for i in range(depth)
        ])
        self.downsample = PatchMerging(dim) if downsample else None

    def forward(self, x, gen=None):
        for blk in self.blocks:
            x = blk(x, gen)
        if self.downsample is not None:
            x = self.downsample(x)
        return x


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    """kvq_tpu's SwinConfig without remat (``use_checkpoint``), which
    changes no result, and without the options that no preset and no
    ``backbone`` override sets (``drop_rate``, ``attn_drop_rate``,
    ``jump_attention``, ``input_key``): the trunk reads the technical
    view."""

    patch_size: tuple[int, int, int] = (2, 4, 4)
    embed_dim: int = 96
    depths: tuple[int, ...] = (2, 2, 6, 2)
    num_heads: tuple[int, ...] = (3, 6, 12, 24)
    window_size: tuple[int, int, int] = (8, 7, 7)
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_path_rate: float = 0.1
    frag_biases: tuple[bool, ...] = (True, True, True, False)
    fragments_hw: int = 7
    use_pallas: bool = False


_PRESETS = {  # reference models/model.py:30-47
    # swin_3d_tiny: no fragment biases
    "swin_tiny": dict(frag_biases=(False,) * 4),
    # the FAST-VQA reproduction: defaults, fragment biases on stages 0-2
    "swin_tiny_grpb": dict(),
    # FAST-VQA-M: small windows, no fragment bias
    "swin_tiny_grpb_m": dict(window_size=(4, 4, 4), frag_biases=(False,) * 4),
    "swin_small": dict(depths=(2, 2, 18, 2), frag_biases=(False,) * 4),
}
SWIN_KEYS = tuple(_PRESETS)  # the model keys whose backbone is a Swin trunk


def swin_config(key: str, backbone_cfg: dict | None) -> SwinConfig:
    """A model key's preset with the ``backbone`` overrides ``window_size``
    and ``use_pallas``; ``checkpoint`` (remat) is accepted and changes no
    result."""
    kw = dict(_PRESETS[key])
    bb = backbone_cfg or {}
    if "window_size" in bb:
        kw["window_size"] = tuple(bb["window_size"])
    if "use_pallas" in bb:
        kw["use_pallas"] = bool(bb["use_pallas"])
    return SwinConfig(**kw)


def make_stages(cfg: SwinConfig) -> nn.ModuleList:
    """The per-stage BasicLayers of a SwinConfig (KSVQE interleaves CDM
    modulation between them)."""
    dpr = np.linspace(0, cfg.drop_path_rate, sum(cfg.depths))
    stages = []
    for i, depth in enumerate(cfg.depths):
        start = sum(cfg.depths[:i])
        stages.append(BasicLayer(
            dim=int(cfg.embed_dim * 2 ** i),
            depth=depth,
            num_heads=cfg.num_heads[i],
            window_size=cfg.window_size,
            mlp_ratio=cfg.mlp_ratio,
            qkv_bias=cfg.qkv_bias,
            drop_paths=tuple(float(d) for d in dpr[start:start + depth]),
            downsample=i < len(cfg.depths) - 1,
            frag_bias=bool(cfg.frag_biases[i]),
            fragments_hw=cfg.fragments_hw,
            use_pallas=cfg.use_pallas,
        ))
    return nn.ModuleList(stages)


class SwinTransformer3D(nn.Module):
    """Patch embed + stages + final LayerNorm over ``batch["technical"]``
    (counterpart of kvq_tpu/nn/swin.py SwinTransformer3D; reference
    swin_backbone.py:1044-1080).  Parameter names are the reference's
    (``patch_embed.*``, ``layers.{i}.blocks.{b}.*``,
    ``layers.{i}.downsample.*``, ``norm.*``).  Takes the batch dict or a
    (B, T, H, W, 3) tensor; returns (B, T', H', W', num_features)."""

    def __init__(self, config: SwinConfig):
        super().__init__()
        self.config = config
        self.patch_embed = PatchEmbed3D(config.patch_size, config.embed_dim)
        self.layers = make_stages(config)
        self.num_features = int(config.embed_dim
                                * 2 ** (len(config.depths) - 1))
        self.norm = LayerNorm(self.num_features)

    def forward(self, batch, gen=None):
        """``gen``: the torch.Generator of a training forward's DropPath
        draws."""
        x = batch["technical"] if isinstance(batch, dict) else batch
        x = self.patch_embed(x.to(self.patch_embed.proj.weight.dtype))
        for stage in self.layers:
            x = stage(x, gen)
        return self.norm(x)
