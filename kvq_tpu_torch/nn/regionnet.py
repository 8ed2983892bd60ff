"""Quality-aware Region Selection (QRS) (counterpart of
kvq_tpu/nn/regionnet.py; reference RegionNet_CLIP, patchnet.py:394-550).

Per keyframe, the CLIP cls-attention map is nearest-resized to the fragment
anchor grid with torch's floor rule, every k_side x k_side anchor window is
a candidate region scored by its mean.  Eval picks the argmax (ties go to
the lowest index, as ``jnp.argmax`` breaks them) and gathers the region;
training takes the perturbed top-1 soft indicator (sample type
``topkpertubation``, its noise drawn from the caller's generator) and the
region is the indicator-weighted sum of the candidate slices.  Each frame
takes its keyframe group's choice.
"""

from __future__ import annotations

import math

import torch

from ..core.device import index_tensor
from ..ops.topk import min_max_norm, perturbed_topk


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
        if self.sample_type != "topkpertubation":
            raise NotImplementedError(
                f"QRS sample type {self.sample_type!r} is not ported yet")
        if gen is None:
            raise ValueError("training QRS draws its noise from a "
                             "torch.Generator: pass gen")
        noise = torch.randn((B * n_key, self.num_samples, scores.shape[-1]),
                            generator=gen, device=scores.device,
                            dtype=scores.dtype)
        ind = perturbed_topk(scores, noise, 1, self.sigma)
        return ind.reshape(B, n_key, -1)[:, gid]

    def __call__(self, fragment, cls_attn, group_id, train: bool = False,
                 gen=None):
        grid_hw = (fragment.shape[2] // self.anchor,
                   fragment.shape[3] // self.anchor)
        sel = self.select(cls_attn, group_id, grid_hw, train, gen)
        if train:
            return extract_region_weighted(fragment, sel, self.anchor,
                                           self.k_side)
        return extract_region_hard(fragment, sel, self.anchor, self.k_side)
