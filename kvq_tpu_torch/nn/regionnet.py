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
"""

from __future__ import annotations

import math

import torch

from ..core.device import index_tensor
from ..ops.topk import (
    categorical_indicator,
    gumbel_topk_indicator,
    index_indicator,
    min_max_norm,
    perturbed_topk,
)

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

    def __call__(self, fragment, cls_attn, group_id, train: bool = False,
                 gen=None):
        grid_hw = (fragment.shape[2] // self.anchor,
                   fragment.shape[3] // self.anchor)
        sel = self.select(cls_attn, group_id, grid_hw, train, gen)
        if train:
            return extract_region_weighted(fragment, sel, self.anchor,
                                           self.k_side)
        return extract_region_hard(fragment, sel, self.anchor, self.k_side)
