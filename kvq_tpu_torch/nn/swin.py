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
version for CPU tensors.  With remat (``use_checkpoint``, JAX's default)
every training block runs under ``torch.utils.checkpoint`` on either
route (:class:`BasicLayer`).  The bias tables get their gradients through the
gather of :func:`expand_bias_planes`.

:class:`SwinTransformer3D` is the whole Video-Swin trunk of the model keys
``swin_tiny``, ``swin_tiny_grpb``, ``swin_tiny_grpb_m`` and ``swin_small``
(presets in :func:`swin_config`), and of :func:`swin_2d_tiny`, the 2D
Swin-T at windows of (1, 7, 7), which the port also builds under the model
key ``swin_2d_tiny`` (with a VQAHead; kvq_tpu's VQANetwork has no such
key).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..ops.train_attention import train_swin_block, window_attention_train
from ..ops.window_attention import (
    WindowGeometry,
    flash_window_attention_packed,
    fused_swin_block,
    gate_and_mask,
    window_attention_plain,
)
from .layers import (
    DropPath,
    LayerNorm,
    Mlp,
    PatchEmbed3D,
    PatchMerging,
    dropout,
    maybe_dropout,
)
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


@functools.lru_cache(maxsize=None)  # kept: a captured graph reads it
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
    at eval and K5 in training.  In training the plain path drops attention
    weights at ``attn_drop`` and the output drops at ``proj_drop``, drawn
    from the forward's generator."""

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

    def bias_planes(self, n):
        rel = expand_bias_planes(self.relative_position_bias_table,
                                 self.table_window, n)
        frag = None
        if self.frag_bias:
            frag = expand_bias_planes(self.fragment_position_bias_table,
                                      self.table_window, n)
        return rel, frag

    def forward(self, x, mask=None, fgate=None, geometry=None, gen=None):
        # x: (B, nW, N, C); mask/fgate: (nW, N, N) or None; geometry: the
        # padded window geometry, given for K3 (eval) or K5 (training, no
        # attention dropout)
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
            drop = None
            if self.training and self.attn_drop > 0.0:
                def drop(p):
                    return dropout(p, self.attn_drop, gen)
            out = window_attention_plain(qkv[0], qkv[1], qkv[2], rel, frag,
                                         fgate, mask, hd ** -0.5, drop)
        out = out.transpose(2, 3).reshape(B, nW, N, C).to(x.dtype)
        return maybe_dropout(self.proj(out), self.proj_drop, self.training,
                             gen)


class SwinBlock3D(nn.Module):
    """One (S)W-MSA + MLP block (reference SwinTransformerBlock3D,
    swin_backbone.py:329-520).  ``drop`` (the attention output's and the
    MLP's dropout) and ``attn_drop`` (the attention weights') act in
    training; with ``jump_attention`` the block has no attention half (nor
    its parameters, as in kvq_tpu) and runs its MLP half alone."""

    def __init__(self, dim, num_heads, window_size, shift, mlp_ratio=4.0,
                 qkv_bias=True, drop_path=0.0, frag_bias=False,
                 fragments_hw=7, use_pallas=False, drop=0.0, attn_drop=0.0,
                 jump_attention=False):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = tuple(window_size)
        self.shift = shift
        self.frag_bias = frag_bias
        self.fragments_hw = fragments_hw
        self.use_pallas = use_pallas
        self.drop, self.attn_drop = drop, attn_drop
        self.jump_attention = jump_attention
        if not jump_attention:
            self.norm1 = LayerNorm(dim)
            self.attn = WindowAttention3D(
                dim, num_heads, window_size, frag_bias=frag_bias,
                qkv_bias=qkv_bias, attn_drop=attn_drop, proj_drop=drop)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop)

    def draws_dropout(self) -> bool:
        """Whether a training forward of the block draws dropout masks."""
        return self.training and (self.drop > 0.0 or self.attn_drop > 0.0)

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

    def drop_path_multipliers(self, batch: int, gen, device):
        """The block's two DropPath multiplier sets (attention branch
        first; each None when nothing drops), drawn from ``gen``."""
        return (self.drop_path.multipliers(batch, gen, device),
                self.drop_path.multipliers(batch, gen, device))

    def forward(self, x, gen=None, dp=None):
        """``gen``: the torch.Generator of a training forward's draws: the
        block's two DropPath multiplier sets (attention branch first, on
        every route), unless ``dp`` holds them already
        (:meth:`drop_path_multipliers`, as a rematerialised block takes
        them), then its dropout masks in forward order.  The routes follow
        kvq_tpu/nn/swin.py:611-660: ``jump_attention`` declines K1 and K4,
        a training forward with dropout declines K4, and one with attention
        dropout declines K5 too (the plain attention drops its weights)."""
        B, D, H, W, C = x.shape
        cfg_shift = (tuple(w // 2 for w in self.window_size) if self.shift
                     else (0, 0, 0))
        window, shift = get_window_size((D, H, W), self.window_size, cfg_shift)
        no_pad = all(d % w == 0 for d, w in zip((D, H, W), window))
        dp1, dp2 = (self.drop_path_multipliers(B, gen, x.device) if dp is None
                    else dp)
        if (self.use_pallas and no_pad and not self.jump_attention
                and not self.draws_dropout()):
            # the gate is decided on the unpadded dims, as the reference's
            probe = self._geometry(B, (D, H, W), window, shift, C)
            if takes_fused_block(probe, C, self.mlp.fc1.out_features,
                                 self.training):
                return self._fused_block(x, window, shift, dp1, dp2)
        if not self.jump_attention:
            x = x + self.drop_path(self._attention(x, window, shift, gen),
                                   dp1)
        return x + self.drop_path(self.mlp(self.norm2(x), gen), dp2)

    def _attention(self, x, window, shift, gen=None):
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
        if self.use_pallas and not (self.training and self.attn_drop > 0.0):
            y = self.attn(y, geometry=geo, gen=gen)
        else:
            gate, mask = gate_and_mask(geo, x.device)
            y = self.attn(y, mask, gate if self.frag_bias else None, gen=gen)
        y = window_reverse(y, window, B, Dp, Hp, Wp)
        if any(shift):
            y = torch.roll(y, shifts=tuple(shift), dims=(1, 2, 3))
        if any(pads):
            y = y[:, :D, :H, :W]
        return y


class BasicLayer(nn.Module):
    """One stage: ``depth`` blocks (alternating shift) + optional
    PatchMerging (reference swin_backbone.py:585-667).

    With ``use_checkpoint`` (remat, JAX's ``nn.remat`` per block) a
    training forward keeps no activation inside a block: the block runs
    under ``torch.utils.checkpoint`` and is recomputed in the backward.
    Its DropPath multipliers are drawn before the checkpointed region, in
    the order of a forward without remat, and passed in, so the recompute
    draws nothing; its parameters are passed in as well, so the recompute
    runs on the tensors the forward ran on (the trainer's compute-dtype
    copies, which ``functional_call`` puts in place only during the
    forward)."""

    def __init__(self, dim, depth, num_heads, window_size, mlp_ratio=4.0,
                 qkv_bias=True, drop_paths=(), downsample=True,
                 frag_bias=False, fragments_hw=7, use_pallas=False,
                 use_checkpoint=False, drop=0.0, attn_drop=0.0,
                 jump_attention=False):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock3D(dim, num_heads, window_size, shift=i % 2 == 1,
                        mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                        drop_path=drop_paths[i] if drop_paths else 0.0,
                        frag_bias=frag_bias, fragments_hw=fragments_hw,
                        use_pallas=use_pallas, drop=drop,
                        attn_drop=attn_drop, jump_attention=jump_attention)
            for i in range(depth)
        ])
        self.downsample = PatchMerging(dim) if downsample else None
        self.use_checkpoint = use_checkpoint

    def forward(self, x, gen=None, dps=None):
        """``dps``: each block's DropPath multipliers, drawn from ``gen``
        block by block when None."""
        remat = (self.use_checkpoint and self.training
                 and torch.is_grad_enabled())
        for i, blk in enumerate(self.blocks):
            dp = (blk.drop_path_multipliers(x.shape[0], gen, x.device)
                  if dps is None else dps[i])
            x = (_rematerialised(blk, x, dp, gen) if remat
                 else blk(x, gen, dp=dp))
        if self.downsample is not None:
            x = self.downsample(x)
        return x


def _rematerialised(blk, x, dp, gen):
    """``blk(x, dp=dp)`` under non-reentrant ``torch.utils.checkpoint``,
    with the block's parameters as inputs of the checkpointed function.  A
    block that draws dropout masks draws them from a copy of ``gen``'s
    state, the same in the forward and in the recompute, and ``gen`` then
    moves on past the forward's draws."""
    names, tensors = zip(*blk.named_parameters())
    state = gen.get_state() if blk.draws_dropout() else None
    after = []

    def run(x, *tensors):
        g = None
        if state is not None:
            g = torch.Generator(device=gen.device)
            g.set_state(state)
        out = functional_call(blk, dict(zip(names, tensors)), (x,),
                              {"gen": g, "dp": dp})
        if g is not None and not after:
            after.append(g.get_state())
        return out

    out = checkpoint(run, x, *tensors, use_reentrant=False,
                     preserve_rng_state=False)
    if after:
        gen.set_state(after[0])
    return out


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    """kvq_tpu's SwinConfig (kvq_tpu/nn/swin.py:765-781).  No preset and no
    ``backbone`` override sets ``drop_rate`` (the patch embed's, each
    attention output's and MLP's dropout), ``attn_drop_rate`` (the
    attention weights'), ``jump_attention`` (per stage: blocks without
    their attention half) or ``input_key`` (the batch key the trunk
    reads); :func:`swin_2d_tiny` takes them.  ``use_checkpoint`` (remat, on
    by default as in JAX) changes no result, only what a training forward
    keeps for its backward."""

    patch_size: tuple[int, int, int] = (2, 4, 4)
    embed_dim: int = 96
    depths: tuple[int, ...] = (2, 2, 6, 2)
    num_heads: tuple[int, ...] = (3, 6, 12, 24)
    window_size: tuple[int, int, int] = (8, 7, 7)
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.1
    frag_biases: tuple[bool, ...] = (True, True, True, False)
    jump_attention: tuple[bool, ...] = (False, False, False, False)
    fragments_hw: int = 7
    use_checkpoint: bool = True
    use_pallas: bool = False
    input_key: str = "technical"


_PRESETS = {  # reference models/model.py:30-47
    # swin_3d_tiny: no fragment biases
    "swin_tiny": dict(frag_biases=(False,) * 4),
    # the FAST-VQA reproduction: defaults, fragment biases on stages 0-2
    "swin_tiny_grpb": dict(),
    # FAST-VQA-M: small windows, no fragment bias
    "swin_tiny_grpb_m": dict(window_size=(4, 4, 4), frag_biases=(False,) * 4),
    "swin_small": dict(depths=(2, 2, 18, 2), frag_biases=(False,) * 4),
    # the 2D Swin-T (kvq_tpu/nn/swin.py:883-898, swin_2d_tiny)
    "swin_2d_tiny": dict(patch_size=(1, 4, 4), window_size=(1, 7, 7),
                         frag_biases=(False,) * 4),
}
# kvq_tpu's VQANetwork keys whose backbone is a Swin trunk
SWIN_KEYS = tuple(k for k in _PRESETS if k != "swin_2d_tiny")


def swin_config(key: str, backbone_cfg: dict | None) -> SwinConfig:
    """A model key's preset with the ``backbone`` overrides
    ``window_size``, ``checkpoint`` (remat) and ``use_pallas``."""
    kw = dict(_PRESETS[key])
    bb = backbone_cfg or {}
    if "window_size" in bb:
        kw["window_size"] = tuple(bb["window_size"])
    if "checkpoint" in bb:
        kw["use_checkpoint"] = bool(bb["checkpoint"])
    if "use_pallas" in bb:
        kw["use_pallas"] = bool(bb["use_pallas"])
    return SwinConfig(**kw)


def swin_2d_tiny(**overrides) -> "SwinTransformer3D":
    """The 2D Swin-T (reference SwinTransformer2D, swin_backbone.py:
    1098-1103: timm's swin_tiny_patch4_window7_224 without its classifier)
    as kvq_tpu builds it: the 3D trunk with a patch and window of depth 1,
    so that every block is a per-frame 2D shifted-window attention over 49
    tokens, and no fragment bias.  ``overrides``: fields of
    :class:`SwinConfig`.  Takes (B, T, H, W, 3), T frames scored alike."""
    return SwinTransformer3D(SwinConfig(**{**_PRESETS["swin_2d_tiny"],
                                           **overrides}))


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
            use_checkpoint=cfg.use_checkpoint,
            drop=cfg.drop_rate,
            attn_drop=cfg.attn_drop_rate,
            jump_attention=bool(cfg.jump_attention[i]),
        ))
    return nn.ModuleList(stages)


class SwinTransformer3D(nn.Module):
    """Patch embed (its dropout at ``drop_rate`` in training) + stages +
    final LayerNorm over ``batch[config.input_key]``
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
        and dropout draws."""
        cfg = self.config
        x = batch[cfg.input_key] if isinstance(batch, dict) else batch
        x = self.patch_embed(x.to(self.patch_embed.proj.weight.dtype))
        x = maybe_dropout(x, cfg.drop_rate, self.training, gen)
        for stage in self.layers:
            x = stage(x, gen)
        return self.norm(x)
