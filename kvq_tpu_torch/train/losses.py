"""Training losses (copy of kvq_tpu/train/losses.py), the reference's
formulas:

  - :func:`plcc_loss` (trainer.py:346-355);
  - :func:`rank_loss` (trainer.py:337-345), which the reference computes and
    never adds: weight 0 by default;
  - :func:`distortion_contrastive_supervised` (KSVQE_model.py:1666-1691):
    supervised InfoNCE over distortion tokens at temperature 0.1, with the
    reference's count-valued positive mask;
  - :func:`total_loss`: 0.3 x the contrastive loss plus the PLCC loss of
    each head (trainer.py:144-153).
"""

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


def _std(x):
    return (x - x.mean()).square().mean().sqrt()


def plcc_loss(y_pred, y):
    """Pearson-correlation-induced loss over a batch of scores (population
    standard deviations, as jnp.std)."""
    y_pred = y_pred.float()
    y = y.float()
    y_pred = (y_pred - y_pred.mean()) / (_std(y_pred) + 1e-8)
    y = (y - y.mean()) / (_std(y) + 1e-8)
    loss0 = ((y_pred - y) ** 2).mean() / 4
    rho = (y_pred * y).mean()
    loss1 = ((rho * y_pred - y) ** 2).mean() / 4
    return (loss0 + loss1) / 2


def rank_loss(y_pred, y):
    """Pairwise ranking hinge, normalised by its own max (+1)."""
    y_pred = y_pred.reshape(-1, 1).float()
    y = y.reshape(-1, 1).float()
    ranking = torch.relu((y_pred - y_pred.T) * torch.sign(y.T - y))
    n = y_pred.shape[0]
    return ranking.sum() / n / (n - 1) / (1.0 + ranking.max())


def total_loss(scores, labels, dis_contra_loss=None,
               contra_weight: float = 0.3, rank_weight: float = 0.0):
    """(loss, aux): contra_weight x dis_contra_loss + the PLCC loss of each
    head's scores [+ rank_weight x its rank loss]; aux holds each term and
    ``total_loss`` as 0-d tensors."""
    y = labels.reshape(-1, 1).float()
    loss = torch.zeros((), dtype=torch.float32, device=y.device)
    aux = {}
    if dis_contra_loss is not None:
        loss = loss + contra_weight * dis_contra_loss
        aux["dis_contra_loss"] = dis_contra_loss
    for i, s in enumerate(scores):
        p = plcc_loss(s, y)
        aux[f"plcc_loss_{i}"] = p
        loss = loss + p
        if rank_weight:
            r = rank_loss(s, y)
            aux[f"rank_loss_{i}"] = r
            loss = loss + rank_weight * r
    aux["total_loss"] = loss
    return loss, aux
