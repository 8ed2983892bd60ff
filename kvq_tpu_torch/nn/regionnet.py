"""Quality-aware Region Selection (QRS) (counterpart of
kvq_tpu/nn/regionnet.py; reference RegionNet_CLIP, patchnet.py:394-550).

Per keyframe, the CLIP cls-attention map is nearest-resized to the fragment
anchor grid with torch's floor rule, every k_side x k_side anchor window is
a candidate region scored by its mean.  Eval picks the argmax (ties go to
the lowest index, as ``jnp.argmax`` breaks them) and gathers the region;
training takes the training indicator of the sample type (perturbed top-1
for ``topkpertubation``, straight-through Gumbel softmax for ``gumbel``, a
categorical draw on the log-scores for ``multinomial``, a uniform index for
``random``), its random draw taken from the caller's generator, and the
region is the indicator-weighted sum of the candidate slices.  Each frame
takes its keyframe group's choice.

The legacy PatchNet family (reference patchnet.py:9-365), which KSVQE does
not use, as kvq_tpu rebuilds it (kvq_tpu/nn/regionnet.py:219-376):
:class:`PredictorLG` and :class:`PredictorLGConv` (score nets, flax's
tanh GELU), :class:`PatchNetMSConv` (two scales blended by per-pixel
weights; the reference's ``PatchNet_ms_conv`` is broken as shipped, its
working ``spatch`` mode is the one kept) and :class:`PatchNetMS` (top-k
frames, or one patch per frame, by learned scores: perturbed top-k in
training, drawn from the caller's generator, the hard top-k at eval).
All are channels-last.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import index_tensor
from ..ops.topk import (
    categorical_indicator,
    gumbel_topk_indicator,
    index_indicator,
    min_max_norm,
    perturbed_topk,
)
from .layers import LayerNorm, conv_channels_last

SAMPLE_TYPES = ("topkpertubation", "gumbel", "multinomial", "random")


def region_scores(cls_attn, grid_hw, k_side: int, stride: int = 1):
    """(B, L) cls-attention -> (B, n_regions) min-max-normalised scores."""
    b, L = cls_attn.shape
    s = int(math.isqrt(L))
    score = cls_attn.reshape(b, s, s)
    gh, gw = grid_hw
    if (s, s) != (gh, gw):
        # nearest resize with F.interpolate's index rule:
        # src = floor(dst * in / out) (reference patchnet.py:476-478)
        rows = torch.arange(gh, device=score.device) * s // gh
        cols = torch.arange(gw, device=score.device) * s // gw
        score = score[:, rows][:, :, cols]
    nh, nw = gh - k_side + 1, gw - k_side + 1
    means = [
        score[:, i:i + k_side, j:j + k_side].mean(dim=(1, 2))
        for i in range(0, nh, stride)
        for j in range(0, nw, stride)
    ]
    return min_max_norm(torch.stack(means, dim=1))


def extract_region_hard(fragment, region_idx, anchor: int, k_side: int):
    """fragment (B, T, H, W, C), region_idx (B, T) -> the selected
    (B, T, k_side*anchor, k_side*anchor, C) regions, one gather."""
    B, T, H, W, C = fragment.shape
    nw = H // anchor - k_side + 1
    side = k_side * anchor
    ar = torch.arange(side, device=fragment.device)
    rows = (region_idx // nw * anchor)[..., None] + ar  # (B, T, side)
    cols = (region_idx % nw * anchor)[..., None] + ar
    bi = torch.arange(B, device=fragment.device)[:, None, None, None]
    ti = torch.arange(T, device=fragment.device)[None, :, None, None]
    return fragment[bi, ti, rows[..., :, None], cols[..., None, :]]


def extract_region_weighted(fragment, weights, anchor: int, k_side: int):
    """fragment (B, T, H, W, C), weights (B, T, n_regions) -> the weighted
    sum of the candidate (k_side*anchor)^2 slices, summed in region order
    in the fragment's dtype (the train path's soft selection)."""
    B, T, H, W, C = fragment.shape
    nh, nw = H // anchor - k_side + 1, W // anchor - k_side + 1
    side = k_side * anchor
    out = None
    for r in range(nh * nw):
        i, j = divmod(r, nw)
        w = weights[:, :, r][..., None, None, None].to(fragment.dtype)
        term = w * fragment[:, :, i * anchor:i * anchor + side,
                            j * anchor:j * anchor + side]
        out = term if out is None else out + term
    return out


def keyframe_schedule(t: int, n_key: int = 4):
    """Static keyframe indices and per-frame group ids (reference
    obtain_keyframes, KSVQE_model.py:1352-1376: keyframes at 0, t/4-1,
    t/2-1, 3t/4-1; the group id increments at each threshold)."""
    thresholds = (t // 4 - 1, t // 2 - 1, t * 3 // 4 - 1)
    keyframes = (0,) + thresholds
    group = []
    gid = 0
    for j in range(t):
        if j in thresholds:
            gid += 1
        group.append(gid)
    return keyframes, tuple(group)


class RegionSelector:
    """QRS: one region per frame.  No parameters; the training draws come
    from the generator the caller passes."""

    def __init__(self, k: int = 49, anchor_size: int = 32, stride: int = 1,
                 num_samples: int = 1, sample_type: str = "topkpertubation",
                 sigma: float = 0.5):
        if sample_type not in SAMPLE_TYPES:
            raise ValueError(f"unknown QRS sample type {sample_type!r}")
        self.k_side = int(math.isqrt(k))
        self.anchor = anchor_size
        self.stride = stride
        self.num_samples = num_samples
        self.sample_type = sample_type
        self.sigma = sigma

    def select(self, cls_attn, group_id, grid_hw, train: bool = False,
               gen=None):
        """cls_attn (B, n_key, L) -> per-frame region indices (B, T) at
        eval, per-frame soft weights (B, T, n_regions) in training."""
        B, n_key, L = cls_attn.shape
        scores = region_scores(cls_attn.reshape(B * n_key, L), grid_hw,
                               self.k_side, self.stride)
        gid = index_tensor(tuple(group_id), cls_attn.device)
        if not train:
            return scores.argmax(dim=-1).reshape(B, n_key)[:, gid]
        ind = self.indicator(scores, self.draw(scores, gen))
        return ind.reshape(B, n_key, -1)[:, gid]

    def n_regions(self, grid_hw) -> int:
        """The candidate regions on an anchor grid (what
        :func:`region_scores` scores)."""
        nh, nw = (len(range(0, g - self.k_side + 1, self.stride))
                  for g in grid_hw)
        return nh * nw

    def draw(self, scores, gen):
        """The training draw of the sample type, from ``gen``: standard
        normal noise (b, num_samples, d) for perturbed top-k, uniform
        (b, d) for Gumbel softmax, standard Gumbel (b, d) for the
        categorical draw, indices (b,) for ``random``."""
        if gen is None:
            raise ValueError("training QRS draws from a torch.Generator: "
                             "pass gen")
        b, d = scores.shape
        kw = dict(generator=gen, device=scores.device)
        if self.sample_type == "topkpertubation":
            return torch.randn((b, self.num_samples, d), dtype=scores.dtype,
                               **kw)
        if self.sample_type == "gumbel":
            return torch.rand((b, d), dtype=scores.dtype, **kw)
        if self.sample_type == "multinomial":
            u = torch.rand((b, d), dtype=scores.dtype, **kw)
            u = u.clamp_min(torch.finfo(scores.dtype).tiny)
            return -torch.log(-torch.log(u))
        return torch.randint(0, d, (b,), **kw)

    def indicator(self, scores, draw):
        """(b, 1, d) training indicator of the sample type from its
        draw."""
        if self.sample_type == "topkpertubation":
            return perturbed_topk(scores, draw, 1, self.sigma)
        if self.sample_type == "gumbel":
            return gumbel_topk_indicator(scores, draw)
        if self.sample_type == "multinomial":
            return categorical_indicator(scores, draw)
        return index_indicator(draw, scores.shape[-1], scores.dtype)


def _tanh_gelu(x):
    return F.gelu(x, approximate="tanh")  # flax's nn.gelu default


class PredictorLG(nn.Module):
    """LayerNorm -> Linear -> GELU, the first half of the channels kept per
    token and the second averaged over the tokens, -> Linear to one score
    -> GELU.  (B, N, dim) -> (B, N, 1)."""

    def __init__(self, dim: int):
        super().__init__()
        self.in_norm = LayerNorm(dim)
        self.in_fc = nn.Linear(dim, dim)
        self.out_fc = nn.Linear(dim, 1)

    def forward(self, x):
        C = x.shape[-1]
        y = _tanh_gelu(self.in_fc(self.in_norm(x)))
        local = y[..., :C // 2]
        glob = y[..., C // 2:].mean(dim=1, keepdim=True).expand_as(local)
        return _tanh_gelu(self.out_fc(torch.cat([local, glob], dim=-1)))


class PredictorLGConv(nn.Module):
    """Conv3x3 (dim -> 2) -> GELU -> Conv3x3 (2 -> 2) -> GELU -> softmax
    over the two channels (the reference's ``nn.Softmax()`` takes the
    channel axis of a 4-D input).  (N, H, W, dim) -> (N, H, W, 2)."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = nn.Conv2d(dim, 2, 3, padding=1)
        self.conv2 = nn.Conv2d(2, 2, 3, padding=1)

    def forward(self, x):
        y = _tanh_gelu(conv_channels_last(self.conv1, x))
        return _tanh_gelu(conv_channels_last(self.conv2, y)).softmax(dim=-1)


class PatchNetMSConv(nn.Module):
    """Two scales stacked along the channels, blended by the per-pixel
    weights of a :class:`PredictorLGConv`: (B, T, H, W, 2 * dim) ->
    (B, T, H, W, dim)."""

    def __init__(self, dim: int):
        super().__init__()
        self.score_network = PredictorLGConv(2 * dim)

    def forward(self, x, gen=None):
        B, T, H, W, C2 = x.shape
        if C2 % 2:
            raise ValueError("PatchNetMSConv: the input stacks two scales "
                             "along the channels")
        flat = x.reshape(B * T, H, W, C2)
        w = self.score_network(flat)
        s1, s2 = flat[..., :C2 // 2], flat[..., C2 // 2:]
        out = w[..., 0:1] * s1 + w[..., 1:2] * s2
        return out.reshape(B, T, H, W, C2 // 2)


class PatchNetMS(nn.Module):
    """Selection by learned :class:`PredictorLG` scores, channels-last
    (B, T, H, W, dim) in:

      - ``mode="time"`` (reference ``score='tpool'``): each frame scored
        from its tokens' mean and max (the net over 2 * dim channels), the
        ``k`` best frames out, in time order: (B, k, H, W, dim);
      - ``mode="spatial"`` (reference ``score='spatch'``): each token
        scored, the ``anchor_size`` square patch (stride ``stride``, by
        default (W - a) // 2) of the best mean score out of each frame:
        (B, T, a, a, dim).

    Training takes the perturbed top-k of ``num_samples`` normal draws
    (:meth:`draw`) at ``sigma``; eval the hard top-k."""

    def __init__(self, dim: int, k: int, anchor_size: int = 7,
                 stride: int | None = None, num_samples: int = 500,
                 sigma: float = 0.05, mode: str = "time"):
        super().__init__()
        if mode not in ("time", "spatial"):
            raise ValueError(f"unknown PatchNetMS mode {mode!r}")
        self.k, self.anchor, self.stride = k, anchor_size, stride
        self.num_samples, self.sigma, self.mode = num_samples, sigma, mode
        self.score_network = PredictorLG(2 * dim if mode == "time" else dim)

    def draw(self, scores, gen):
        """(b, num_samples, d) standard normal noise from ``gen``."""
        if gen is None:
            raise ValueError("a training PatchNetMS draws from a "
                             "torch.Generator: pass gen")
        return torch.randn((*scores.shape[:1], self.num_samples,
                            scores.shape[-1]), generator=gen,
                           dtype=scores.dtype, device=scores.device)

    def forward(self, x, gen=None):
        B, T, H, W, C = x.shape
        if self.mode == "time":
            tok = x.reshape(B, T, H * W, C)
            pooled = torch.cat([tok.mean(dim=2), tok.amax(dim=2)], dim=-1)
            scores = min_max_norm(self.score_network(pooled)[..., 0])
            flat = x.reshape(B, T, H * W * C)
            if self.training:
                ind = perturbed_topk(scores, self.draw(scores, gen), self.k,
                                     self.sigma)
                sel = torch.einsum("bkt,btd->bkd", ind.to(flat.dtype), flat)
            else:
                idx = scores.topk(self.k, dim=-1).indices.sort(dim=-1).values
                sel = flat.gather(1, idx[..., None].expand(-1, -1,
                                                           flat.shape[-1]))
            return sel.reshape(B, self.k, H, W, C)
        a = self.anchor
        s = self.stride or max((W - a) // 2, 1)
        sc = self.score_network(x.reshape(B * T, H * W, C))
        score_patches = F.unfold(sc.reshape(B * T, 1, H, W), a, stride=s)
        scores = min_max_norm(score_patches.mean(dim=1))  # (BT, nP)
        patches = F.unfold(x.reshape(B * T, H, W, C).permute(0, 3, 1, 2), a,
                           stride=s).transpose(1, 2)  # (BT, nP, C*a*a)
        if self.training:
            ind = perturbed_topk(scores, self.draw(scores, gen), 1, self.sigma)
            sel = torch.einsum("bkp,bpd->bkd", ind.to(patches.dtype),
                               patches)[:, 0]
        else:
            idx = scores.argmax(dim=-1)
            sel = patches[torch.arange(B * T, device=x.device), idx]
        # unfold's features are channel-major, (C, a, a)
        return sel.reshape(B, T, C, a, a).permute(0, 1, 3, 4, 2)
