"""Quality-assessment metrics (copy of kvq_tpu/core/metrics.py's eval part).

SRCC/PLCC/KRCC/RMSE with the predictions z-score rescaled to the label
distribution first, as reference trainer.py:213-222 and :356-361 do.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
from scipy.stats import kendalltau, pearsonr, spearmanr


class VQAMetrics(NamedTuple):
    srcc: float
    plcc: float
    krcc: float
    rmse: float


def rescale(pr: Sequence[float], gt: Sequence[float] | None = None) -> np.ndarray:
    """Z-score predictions; if labels given, match their mean/std."""
    pr = np.asarray(pr, dtype=np.float64)
    if gt is None:
        return (pr - np.mean(pr)) / np.std(pr)
    gt = np.asarray(gt, dtype=np.float64)
    return ((pr - np.mean(pr)) / np.std(pr)) * np.std(gt) + np.mean(gt)


def vqa_metrics(
    labels: Sequence[float], preds: Sequence[float], do_rescale: bool = True
) -> VQAMetrics:
    """SRCC/PLCC/KRCC/RMSE on (rescaled) predictions."""
    labels = np.asarray(labels, dtype=np.float64)
    preds = np.asarray(preds, dtype=np.float64)
    if do_rescale:
        preds = rescale(preds, labels)
    s = spearmanr(labels, preds)[0]
    p = pearsonr(labels, preds)[0]
    k = kendalltau(labels, preds)[0]
    r = float(np.sqrt(((labels - preds) ** 2).mean()))
    return VQAMetrics(float(s), float(p), float(k), r)
