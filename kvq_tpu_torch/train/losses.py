"""Distortion contrastive loss (copy of kvq_tpu/train/losses.py:45; reference
KSVQE_model.py:1666-1691): supervised InfoNCE over distortion tokens at
temperature 0.1, with the reference's count-valued positive mask."""

from __future__ import annotations

import torch


def distortion_contrastive_supervised(distortion_feature, dis_label):
    """distortion_feature (B, T, G, C), dis_label (B,) int -> scalar."""
    b, t, g, c = distortion_feature.shape
    tg = t * g
    n = b * tg
    z = distortion_feature.reshape(n, c).float()
    z = z / (z.norm(dim=1, keepdim=True) + 1e-12)
    sim = (z @ z.T) / 0.1
    # positive[i, j] = P[b_i, b_j] for every j of batch block b_j, so the
    # (N, N) contractions collapse to per-block row sums
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
