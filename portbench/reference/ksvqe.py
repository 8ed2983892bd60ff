"""KSVQE (arXiv:2402.07220), the plain path in float32: CLIP ViT-B/16
with cls-token adapters, quality-aware region selection (QRS), CONTRIQUE's
ResNet-50 with its projector, the Swin-T-3D trunk, and the CDM modulation
(cross-attentions to CLIP's and CONTRIQUE's tokens, a temporal attention,
FiLM) after stages ``tuning_stage`` to 3.  A frozen copy of the port's
plain route with ``s2d_input`` (the host packs each 2x4x4 patch into
channels).

QRS picks one region a keyframe by the argmax of its region scores (at
eval) or of the scores perturbed by ``sigma`` times a normal draw (in
training).  With seeded random weights those scores lie close together,
so rounding alone can move a pick.  The reference therefore can take the
picks of the program it judges (``RegionSelector.follow``): each entry is
the program's (cls-attention, pick) of one call.  It then judges that
stage by itself: the program's pick has to be exactly what the selection
rule gives on the program's own cls-attention (``pick_errors``), and the
program's cls-attention is compared with the reference's own
(``cls_attn_gap``).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import LayerNorm, PatchEmbed3D, avg_std_pool, conv1x1
from .swin import SwinConfig, make_stages

# --------------------------------------------------------------- CLIP ViT


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@functools.lru_cache(maxsize=None)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """Antialiased bicubic (Keys, a = -0.5) weights, as jax.image.resize."""
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


def resize_pos_embed_2d(pos_embed, src_grid: int, dst_grid):
    gh, gw = dst_grid
    if (src_grid, src_grid) == (gh, gw):
        return pos_embed
    grid = pos_embed[1:].reshape(src_grid, src_grid, -1)
    wh = torch.as_tensor(_resize_weights(src_grid, gh), device=grid.device)
    ww = torch.as_tensor(_resize_weights(src_grid, gw), device=grid.device)
    grid = torch.einsum("ia,ijc,jb->abc", wh, grid, ww)
    return torch.cat([pos_embed[:1], grid.reshape(gh * gw, -1)])


class AdapterMLP(nn.Sequential):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__(nn.Linear(in_dim, in_dim // 4), nn.ReLU(),
                         nn.Linear(in_dim // 4, out_dim), nn.ReLU())


class CLIPAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x):
        B, N, C = x.shape
        h, hd = self.heads, C // self.heads
        q, k, v = (F.linear(x, self.in_proj_weight, self.in_proj_bias)
                   .reshape(B, N, 3, h, hd).permute(2, 0, 3, 1, 4))
        attn = torch.matmul(q * hd ** -0.5, k.transpose(-1, -2))
        out = torch.matmul(attn.softmax(dim=-1), v)
        return self.out_proj(out.transpose(1, 2).reshape(B, N, C))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.attn = CLIPAttention(width, heads)
        self.ln_1 = LayerNorm(width)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(width, 4 * width)),
            ("gelu", nn.Identity()),
            ("c_proj", nn.Linear(4 * width, width)),
        ]))
        self.ln_2 = LayerNorm(width)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        m = self.mlp
        return x + m.c_proj(quick_gelu(m.c_fc(self.ln_2(x))))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(width, heads) for _ in range(layers)])


class VisualTransformer(nn.Module):
    def __init__(self, width, layers, heads, patch_size, image_grid):
        super().__init__()
        self.image_grid = image_grid
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size,
                               bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(
            torch.zeros(1 + image_grid ** 2, width))
        self.ln_pre = LayerNorm(width)
        self.transformer = Transformer(width, layers, heads)


class CLIPVisionTower(nn.Module):
    """(B, H, W, 3) -> (cls-attention (B, L), patch tokens (B, L, C))."""

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

    def forward(self, x):
        v = self.visual
        B = x.shape[0]
        x = v.conv1(x.float().permute(0, 3, 1, 2))
        gh, gw = x.shape[2], x.shape[3]
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([v.class_embedding.expand(B, 1, -1), x], dim=1)
        pe = resize_pos_embed_2d(v.positional_embedding, v.image_grid,
                                 (gh, gw))
        x = v.ln_pre(x + pe[None])
        for i, blk in enumerate(v.transformer.resblocks):
            x = blk(x)
            if i >= self.clip_location and len(self.adapter_layer):
                a = self.adapter_layer[i - self.clip_location](x[:, :1])
                r = self.adapter_ratio
                x = torch.cat([r * a + (1 - r) * x[:, :1], x[:, 1:]], dim=1)
        cf, pf = x[:, 0], x[:, 1:]
        cls_attn = torch.einsum("bc,blc->bl", cf, pf) / (
            cf.norm(dim=-1, keepdim=True) * pf.norm(dim=-1) + 1e-8)
        return cls_attn, pf


# -------------------------------------------------------------- CONTRIQUE


class FrozenBatchNorm2d(nn.BatchNorm2d):
    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class BottleneckBlock(nn.Module):
    def __init__(self, inplanes, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
                FrozenBatchNorm2d(planes * 4))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(y + res)


class ResNetTrunk(nn.Sequential):
    def __init__(self, layers=(3, 4, 6, 3)):
        stages = []
        inplanes = 64
        for stage, n_blocks in enumerate(layers):
            planes = 64 * 2 ** stage
            stride = 1 if stage == 0 else 2
            blocks = []
            for b in range(n_blocks):
                ds = b == 0 and (stride != 1 or inplanes != planes * 4)
                blocks.append(BottleneckBlock(inplanes, planes,
                                              stride if b == 0 else 1, ds))
                inplanes = planes * 4
            stages.append(nn.Sequential(*blocks))
        super().__init__(
            nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False),
            FrozenBatchNorm2d(64), nn.ReLU(),
            nn.MaxPool2d(3, stride=2, padding=1), *stages)


class CONTRIQUE(nn.Module):
    """ResNet-50 over each 32 px anchor cell, then the projector:
    (B, T, H, W, 3) -> (B, T, cells, 128)."""

    def __init__(self, anchor_size=32, layers=(3, 4, 6, 3),
                 projection_dim=128):
        super().__init__()
        self.anchor_size = anchor_size
        self.projection_dim = projection_dim
        self.encoder = ResNetTrunk(layers)
        self.projector = nn.Sequential(
            nn.Linear(2048, 2048, bias=False), nn.BatchNorm1d(2048),
            nn.ReLU(), nn.Linear(2048, projection_dim, bias=False),
            nn.BatchNorm1d(projection_dim))

    @staticmethod
    def _bn(bn, z):
        return F.batch_norm(z, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)

    def forward(self, x):
        B, T, H, W, C = x.shape
        a = self.anchor_size
        gh, gw = H // a, W // a
        patches = (x.reshape(B, T, gh, a, gw, a, C)
                   .permute(0, 1, 2, 4, 3, 5, 6)
                   .reshape(B * T * gh * gw, a, a, C).float())
        h = self.encoder(patches.permute(0, 3, 1, 2)).mean(dim=(2, 3))
        h = h / (h.norm(dim=1, keepdim=True) + 1e-12)
        p = self.projector
        z = F.relu(self._bn(p[1], F.linear(h, p[0].weight)))
        z = self._bn(p[4], F.linear(z, p[3].weight))
        return z.reshape(B, T, gh * gw, self.projection_dim)


# -------------------------------------------------------------------- CDM


def _heads(t, h):
    B, N, C = t.shape
    return t.reshape(B, N, h, C // h).transpose(1, 2)


def _merge(t):
    B, h, N, hd = t.shape
    return t.transpose(1, 2).reshape(B, N, h * hd)


class CrossAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.fc_q = nn.Linear(dim, dim)
        self.fc_k = nn.Linear(dim, dim)
        self.fc_v = nn.Linear(dim, dim)

    def forward(self, q_tokens, kv_tokens):
        C = q_tokens.shape[-1]
        h = self.num_heads
        q = _heads(self.fc_q(q_tokens), h)
        k = _heads(self.fc_k(kv_tokens), h)
        v = _heads(self.fc_v(kv_tokens), h)
        attn = torch.matmul(q, k.transpose(-1, -2)) / C ** 0.5
        return _merge(torch.matmul(attn.softmax(dim=-1), v))


class TemporalAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.to_qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.to_out = nn.Sequential(nn.Linear(dim, dim), nn.Dropout(0.0))

    def forward(self, x):
        C = x.shape[-1]
        h = self.num_heads
        q, k, v = self.to_qkv(x).split(C, dim=-1)
        q = _heads(q, h) * (C // h) ** -0.5
        attn = torch.matmul(q, _heads(k, h).transpose(-1, -2))
        out = _merge(torch.matmul(attn.softmax(dim=-1), _heads(v, h)))
        return self.to_out[0](out)


class SemanticFiLM(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv_gama = nn.Conv2d(dim, 1, 1)
        self.conv_beta = nn.Conv2d(dim, 1, 1)

    def forward(self, x, inp):
        gamma = torch.sigmoid(conv1x1(self.conv_gama, x))
        return gamma * inp + conv1x1(self.conv_beta, x)


class DistFiLM(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.get_gamma = nn.Linear(dim, dim)
        self.get_beta = nn.Linear(dim, dim)

    def forward(self, x, inp):
        mean, std = avg_std_pool(x.reshape(x.shape[0], -1, x.shape[-1]), (1,))
        gamma, beta = torch.sigmoid(self.get_gamma(std)), self.get_beta(mean)
        return gamma[:, None, :] * inp + beta[:, None, :]


def distortion_contrastive_supervised(distortion_feature, dis_label):
    """Supervised InfoNCE over the distortion tokens at temperature 0.1,
    with the reference's count-valued positive mask."""
    b, t, g, c = distortion_feature.shape
    tg = t * g
    n = b * tg
    z = distortion_feature.reshape(n, c).float()
    z = z / (z.norm(dim=1, keepdim=True) + 1e-12)
    sim = (z @ z.T) / 0.1
    same = (dis_label[:, None] == dis_label[None, :]).float()
    P = same @ same.T
    diag_sim = torch.diagonal(sim)
    denominator = torch.exp(sim).sum(dim=1) - torch.exp(diag_sim)
    row_block = sim.reshape(n, b, tg).sum(dim=2)
    P_rows = P.repeat_interleave(tg, dim=0)
    P_diag = torch.diagonal(P).repeat_interleave(tg)
    numerator = (P_rows * row_block).sum(dim=1) - P_diag * diag_sim
    positive_sum = P_rows.sum(dim=1) * tg - P_diag
    return torch.mean(torch.log(denominator) - numerator / positive_sum)


# -------------------------------------------------------------------- QRS


def keyframe_schedule(t: int):
    """Keyframes 0, t/4-1, t/2-1, 3t/4-1 and each frame's group."""
    thresholds = (t // 4 - 1, t // 2 - 1, t * 3 // 4 - 1)
    group, gid = [], 0
    for j in range(t):
        if j in thresholds:
            gid += 1
        group.append(gid)
    return (0,) + thresholds, tuple(group)


def region_scores(cls_attn, grid_hw, k_side: int):
    """(b, L) cls-attention -> (b, regions) min-max-normalised means of
    every k_side x k_side window of the map resized to the anchor grid."""
    b, L = cls_attn.shape
    s = int(math.isqrt(L))
    score = cls_attn.reshape(b, s, s)
    gh, gw = grid_hw
    if (s, s) != (gh, gw):
        rows = torch.arange(gh, device=score.device) * s // gh
        cols = torch.arange(gw, device=score.device) * s // gw
        score = score[:, rows][:, :, cols]
    nh, nw = gh - k_side + 1, gw - k_side + 1
    means = torch.stack([score[:, i:i + k_side, j:j + k_side].mean(dim=(1, 2))
                         for i in range(nh) for j in range(nw)], dim=1)
    mn = means.amin(dim=-1, keepdim=True)
    mx = means.amax(dim=-1, keepdim=True)
    return (means - mn) / (mx - mn + 1e-5)


class _PerturbedTop1(torch.autograd.Function):
    """The perturbed top-1 indicator, given its forward value (the
    one-hot of the pick), with the perturbed top-k's gradient."""

    @staticmethod
    def forward(ctx, x, noise, onehot, sigma):
        ctx.sigma = sigma
        ctx.save_for_backward(onehot, noise)
        return onehot.mean(dim=1)

    @staticmethod
    def backward(ctx, g):
        onehot, noise = ctx.saved_tensors
        expected = (torch.einsum("bnkd,bnd->bkd", onehot, noise)
                    / noise.shape[1] / ctx.sigma)
        return torch.einsum("bkd,bkd->bd", g, expected), None, None, None


class RegionSelector:
    """QRS with ``topkpertubation`` training draws.  ``follow``: a deque of
    the program's (cls-attention, pick) per call, taken in order; each
    call then adds to ``pick_errors`` and ``cls_attn_gap``."""

    def __init__(self, k=49, anchor_size=32, num_samples=1, sigma=0.5):
        self.k_side = int(math.isqrt(k))
        self.anchor = anchor_size
        self.num_samples = num_samples
        self.sigma = sigma
        self.follow: collections.deque | None = None
        self.record: list | None = None
        self.pick_errors = 0
        self.cls_attn_gap = 0.0

    def _rule(self, scores, noise):
        if noise is None:
            return scores.argmax(dim=-1)
        perturbed = scores[:, None, :] + noise * self.sigma
        return perturbed.argmax(dim=-1)  # (b, nS)

    def select(self, cls_attn, group_id, grid_hw, train, gen):
        B, n_key, L = cls_attn.shape
        scores = region_scores(cls_attn.reshape(B * n_key, L), grid_hw,
                               self.k_side)
        b, d = scores.shape
        noise = None
        if train:
            noise = torch.randn((b, self.num_samples, d), generator=gen,
                                device=scores.device)
        gid = torch.as_tensor(group_id, device=scores.device)
        idx = self._rule(scores, noise)
        theirs = self.follow.popleft() if self.follow else None
        if theirs is not None and theirs[0].shape != cls_attn.shape:
            # the program's call saw another batch: every pick is wrong
            self.cls_attn_gap = float("inf")
            self.pick_errors += b
        elif theirs is not None:
            their_attn = theirs[0].to(cls_attn.device).float()
            ca = cls_attn.detach()
            rel = (their_attn - ca).abs().amax() / ca.abs().amax()
            self.cls_attn_gap = max(self.cls_attn_gap, float(rel))
            want = self._rule(region_scores(their_attn.reshape(b, L),
                                            grid_hw, self.k_side), noise)
            first = [group_id.index(g) for g in range(n_key)]
            their_pick = theirs[1].to(scores.device)
            if train:  # (B, T, d) indicator -> the (b, nS) pick per keyframe
                got = their_pick[:, first].reshape(b, 1, d).argmax(-1)
                got = got.expand(b, self.num_samples)
            else:      # (B, T) indices
                got = their_pick[:, first].reshape(b)
            self.pick_errors += int((got != want).sum())
            idx = got
        if not train:
            out = idx.reshape(B, n_key)[:, gid]
        else:
            onehot = F.one_hot(idx[..., None], d).float()  # (b, nS, 1, d)
            ind = _PerturbedTop1.apply(scores, noise, onehot, self.sigma)
            out = ind.reshape(B, n_key, -1)[:, gid]
        if self.record is not None:
            self.record.append((cls_attn.detach(), out.detach()))
        return out


def extract_region_hard(fragment, region_idx, anchor: int, k_side: int):
    B, T, H, W, C = fragment.shape
    nw = H // anchor - k_side + 1
    side = k_side * anchor
    ar = torch.arange(side, device=fragment.device)
    rows = (region_idx // nw * anchor)[..., None] + ar
    cols = (region_idx % nw * anchor)[..., None] + ar
    bi = torch.arange(B, device=fragment.device)[:, None, None, None]
    ti = torch.arange(T, device=fragment.device)[None, :, None, None]
    return fragment[bi, ti, rows[..., :, None], cols[..., None, :]]


def extract_region_weighted(fragment, weights, anchor: int, k_side: int):
    B, T, H, W, C = fragment.shape
    nh, nw = H // anchor - k_side + 1, W // anchor - k_side + 1
    side = k_side * anchor
    out = 0
    for r in range(nh * nw):
        i, j = divmod(r, nw)
        w = weights[:, :, r][..., None, None, None]
        out = out + w * fragment[:, :, i * anchor:i * anchor + side,
                                 j * anchor:j * anchor + side]
    return out


# ------------------------------------------------------------------ KSVQE


@dataclasses.dataclass(frozen=True)
class KSVQEConfig:
    num_samples: int = 1
    sigma: float = 0.5
    clip_location: int = 8
    cls_use: bool = True
    tuning_stage: int = 1
    a1: float = 1.0
    a2: float = 0.0
    anchor_size: int = 32
    region_k: int = 49
    patch_size: tuple[int, int, int] = (2, 4, 4)
    embed_dim: int = 96
    depths: tuple[int, ...] = (2, 2, 6, 2)
    num_heads: tuple[int, ...] = (3, 6, 12, 24)
    window_size: tuple[int, int, int] = (8, 7, 7)
    drop_path_rate: float = 0.1
    frag_biases: tuple[bool, ...] = (True, True, True, False)
    contrique_layers: tuple[int, ...] = (3, 4, 6, 3)
    clip_layers: int = 12
    clip_width: int = 768
    clip_heads: int = 12


def ksvqe_config(bb: dict) -> KSVQEConfig:
    """From the YAML backbone block (``config/Kwai_KSVQE.yml``)."""
    if bb.get("sample_type", "topkpertubation") != "topkpertubation":
        raise ValueError("the reference draws topkpertubation only")
    if not bb.get("s2d_input", False):
        raise ValueError("the reference takes s2d-packed fragments only")
    d = KSVQEConfig()
    return KSVQEConfig(
        num_samples=int(bb.get("num_samples", d.num_samples)),
        sigma=float(bb.get("sigma", d.sigma)),
        clip_location=int(bb.get("CLIP_location", d.clip_location)),
        cls_use=bool(bb.get("cls_use", d.cls_use)),
        tuning_stage=int(bb.get("tuning_stage", d.tuning_stage)),
        a1=float(bb.get("a1", d.a1)), a2=float(bb.get("a2", d.a2)),
        anchor_size=int(bb.get("anchor_size", d.anchor_size)),
        region_k=int(bb.get("region_k", d.region_k)),
        patch_size=tuple(bb.get("patch_size", d.patch_size)),
        embed_dim=int(bb.get("embed_dim", d.embed_dim)),
        depths=tuple(bb.get("depths", d.depths)),
        num_heads=tuple(bb.get("num_heads", d.num_heads)),
        window_size=tuple(bb.get("window_size", d.window_size)),
        drop_path_rate=float(bb.get("drop_path_rate", d.drop_path_rate)),
        contrique_layers=tuple(bb.get("contrique_layers",
                                      d.contrique_layers)),
        clip_layers=int(bb.get("clip_layers", d.clip_layers)),
        clip_width=int(bb.get("clip_width", d.clip_width)),
        clip_heads=int(bb.get("clip_heads", d.clip_heads)))


class KSVQE(nn.Module):
    def __init__(self, cfg: KSVQEConfig):
        super().__init__()
        self.config = cfg
        self.CLIP_tool = CLIPVisionTower(
            width=cfg.clip_width, layers=cfg.clip_layers,
            heads=cfg.clip_heads, clip_location=cfg.clip_location,
            cls_use=cfg.cls_use)
        self.distortion_tool = CONTRIQUE(anchor_size=cfg.anchor_size,
                                         layers=cfg.contrique_layers)
        self.dist_adapter = AdapterMLP(128, 128)
        self.selector = RegionSelector(cfg.region_k, cfg.anchor_size,
                                       cfg.num_samples, cfg.sigma)
        self.patch_embed = PatchEmbed3D(cfg.patch_size, cfg.embed_dim)
        self.layers = make_stages(SwinConfig(
            patch_size=cfg.patch_size, embed_dim=cfg.embed_dim,
            depths=cfg.depths, num_heads=cfg.num_heads,
            window_size=cfg.window_size, drop_path_rate=cfg.drop_path_rate,
            frag_biases=cfg.frag_biases))
        n_stages = len(cfg.depths)
        self.num_features = int(cfg.embed_dim * 2 ** (n_stages - 1))
        self.norm = LayerNorm(self.num_features)
        mods = collections.defaultdict(list)
        for l in range(cfg.tuning_stage, n_stages):
            dim = int(cfg.embed_dim * 2 ** (min(l, n_stages - 2) + 1))
            heads = cfg.num_heads[l]
            mods["semantic_adapter"].append(AdapterMLP(cfg.clip_width, dim))
            mods["distortion_adapter"].append(AdapterMLP(128, dim))
            mods["semantic_cross"].append(CrossAttention(dim, heads))
            mods["distortion_cross"].append(CrossAttention(dim, heads))
            mods["distortion_self"].append(TemporalAttention(dim, heads))
            mods["semantic_mod"].append(SemanticFiLM(dim))
            mods["distortion_mod"].append(DistFiLM(dim))
        for k in ("semantic_adapter", "distortion_adapter", "semantic_cross",
                  "distortion_cross", "distortion_self", "semantic_mod",
                  "distortion_mod"):
            setattr(self, k, nn.ModuleList(mods[k]))
        n_mod = n_stages - cfg.tuning_stage
        self.a1 = nn.Parameter(torch.full((n_mod, 1), float(cfg.a1)))
        self.a2 = nn.Parameter(torch.full((n_mod, 1), float(cfg.a2)))

    def _select_and_embed(self, fragment, cls_attn, group_id, gen):
        pt, ph, pw = self.config.patch_size
        B, T2, Hp, Wp, K = fragment.shape
        Cs = K // pt
        anchor = self.selector.anchor // ph
        k_side = self.selector.k_side
        train = self.training
        sel = self.selector.select(cls_attn, group_id,
                                   (Hp // anchor, Wp // anchor), train, gen)
        extract = extract_region_weighted if train else extract_region_hard
        halves = [extract(fragment[..., ti * Cs:(ti + 1) * Cs],
                          sel[:, ti::pt], anchor, k_side)
                  for ti in range(pt)]
        x = self.patch_embed(torch.cat(halves, dim=-1), packed=True)
        ev = halves[0].detach()
        _, _, h2, w2, _ = ev.shape
        c = Cs // (ph * pw)
        dist_in = (ev.reshape(B, T2, h2, w2, ph, pw, c)
                   .permute(0, 1, 2, 4, 3, 5, 6)
                   .reshape(B, T2, h2 * ph, w2 * pw, c))
        return x, dist_in

    def forward(self, batch, gen=None):
        cfg = self.config
        revideo = batch["resize_video"].float()
        fragment = batch["fragment"].float()
        B = fragment.shape[0]
        T = fragment.shape[1] * cfg.patch_size[0]
        keyframes, group_id = keyframe_schedule(T)
        n_key = len(keyframes)
        kf = revideo[:, list(keyframes)]
        cls_attn, pat_tokens = self.CLIP_tool(
            kf.reshape(B * n_key, *kf.shape[2:]))
        L = cls_attn.shape[-1]
        cls_attn = cls_attn.reshape(B, n_key, L)
        pat_tokens = pat_tokens.reshape(B, n_key, L, -1)
        gid_half = group_id[::2]
        tg = len(gid_half) // n_key
        sem_grouped = gid_half == tuple(g for g in range(n_key)
                                        for _ in range(tg))
        x, dist_in = self._select_and_embed(fragment, cls_attn, group_id, gen)
        dist_tok = self.distortion_tool(dist_in)
        dist_tok = 0.2 * self.dist_adapter(dist_tok) + 0.8 * dist_tok
        dis_loss = distortion_contrastive_supervised(dist_tok,
                                                     batch["dis_label"])
        ts = cfg.tuning_stage
        for l, stage in enumerate(self.layers):
            x = stage(x, gen)
            if l < ts:
                continue
            m = l - ts
            n, t, h, w, c = x.shape
            pt_key = self.semantic_adapter[m](pat_tokens)
            xs = x.reshape(n * t, h * w, c)
            if sem_grouped:
                enh = self.semantic_cross[m](
                    x.reshape(n * n_key, tg * h * w, c),
                    pt_key.reshape(n * n_key, L, c)).reshape(n * t, h * w, c)
            else:
                ix = torch.as_tensor(gid_half, device=x.device)
                enh = self.semantic_cross[m](
                    xs, pt_key[:, ix].reshape(n * t, L, c))
            fors = self.semantic_mod[m](
                enh.reshape(n * t, h, w, c),
                x.reshape(n * t, h, w, c)).reshape(n, t, h, w, c)
            G = dist_tok.shape[2]
            dtk = self.distortion_adapter[m](dist_tok).reshape(n * t, G, c)
            denh = self.distortion_cross[m](xs, dtk)
            denh = (denh.reshape(n, t, h * w, c).transpose(1, 2)
                    .reshape(n * h * w, t, c))
            denh = self.distortion_self[m](denh)
            denh = (denh.reshape(n, h * w, t, c).transpose(1, 2)
                    .reshape(n, t, h, w, c))
            ford = self.distortion_mod[m](
                denh, x.reshape(n, t * h * w, c)).reshape(n, t, h, w, c)
            x = (self.a1[m] * ford + self.a2[m] * fors) / 2
        return self.norm(x), dis_loss
