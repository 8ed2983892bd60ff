"""Eval-side top-k helpers (copy of kvq_tpu/ops/topk.py's eval part)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def hard_topk_indicator(x, k: int):
    """Exact top-k as a (b, k, d) one-hot indicator, indices sorted
    ascending (HardTopK semantics, reference patchnet.py:60)."""
    idx = torch.topk(x, k, dim=-1).indices.sort(dim=-1).values
    return F.one_hot(idx, x.shape[-1]).to(x.dtype)


def min_max_norm(x, dim: int = -1, eps: float = 1e-5):
    """Reference min_max_norm (patchnet.py:160-164)."""
    mn = x.amin(dim=dim, keepdim=True)
    mx = x.amax(dim=dim, keepdim=True)
    return (x - mn) / (mx - mn + eps)
