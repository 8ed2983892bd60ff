"""Quality-assessment metrics (copy of kvq_tpu/core/metrics.py).

SRCC/PLCC/KRCC/RMSE with the predictions z-score rescaled to the label
distribution first, as reference trainer.py:213-222 and :356-361 do; the
NTIRE 2024 KVQ challenge score ``0.45*SROCC + 0.45*PLCC + 0.05*acc_nonsource
+ 0.05*acc_source`` (reference metric_score.py:45) with its ranked-pair
accuracies, read from CSV files with the ``csv`` module (no pandas).
"""

from __future__ import annotations

import csv
import os.path as osp
from typing import Iterable, Mapping, NamedTuple, Sequence

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


def pairwise_rank_accuracy(
    scores: Mapping[str, float], ranked_pairs: Iterable[tuple[str, str]]
) -> float:
    """Fraction of (better, worse) pairs the scores order correctly; pairs
    naming a video without a score are skipped (reference
    metric_score.py:20-41)."""
    total = 0
    correct = 0
    for a, b in ranked_pairs:
        if a not in scores or b not in scores:
            continue
        total += 1
        if scores[a] > scores[b]:
            correct += 1
    if total == 0:
        return 0.0
    return correct / total


def challenge_score(
    srcc: float,
    plcc: float,
    acc_nonsource: float = 0.0,
    acc_source: float = 0.0,
) -> float:
    """NTIRE 2024 KVQ final score (reference metric_score.py:45)."""
    return 0.45 * srcc + 0.45 * plcc + 0.05 * acc_nonsource + 0.05 * acc_source


def _read_rows(path: str) -> list[list[str]]:
    """The rows of a CSV file after its header row."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return [r for r in rows[1:] if r]


def _scores(path: str) -> list[tuple[str, float]]:
    """``(filename, score)`` rows of a CSV whose first two columns are the
    file name and the score, whatever its header says (the JAX version
    renames the columns ``filename,score``)."""
    return [(r[0], float(r[1])) for r in _read_rows(path)]


def _rank_pairs(source: str, sheet: str) -> list[tuple[str, str]]:
    """The (better, worse) pairs of one sheet: ``<source>/<sheet>.csv``
    when ``source`` is a directory, else the sheet of an xlsx workbook,
    read with openpyxl (the first two columns after the header row)."""
    if osp.isdir(source):
        return [(r[0], r[1]) for r in
                _read_rows(osp.join(source, f"{sheet}.csv"))]
    try:
        import openpyxl
    except ImportError as e:
        raise ImportError(
            "reading the rank-pair xlsx needs openpyxl; "
            "alternatively pass a directory with "
            "nonsource.csv/source.csv"
        ) from e
    wb = openpyxl.load_workbook(source, read_only=True, data_only=True)
    try:
        rows = list(wb[sheet].iter_rows(min_row=2, values_only=True))
    finally:
        wb.close()
    return [(r[0], r[1]) for r in rows if r and r[0] is not None]


def score_prediction_file(
    pred_csv: str,
    truth_csv: str,
    rank_pairs: str | None = None,
) -> dict:
    """The challenge's scoring (reference metric_score.py, made runnable):
    both CSVs hold ``filename,score`` rows after a header; they are joined
    on the file name (inner join).  ``rank_pairs`` is a directory holding
    ``nonsource.csv`` and ``source.csv`` or an xlsx with sheets of those
    names; each row pairs a strictly better video with a worse one."""
    pred = _scores(pred_csv)
    truth = _scores(truth_csv)
    # pandas' inner merge: each prediction row, in order, with every truth
    # row of its file name, in theirs
    by_name: dict[str, list[float]] = {}
    for name, score in truth:
        by_name.setdefault(name, []).append(score)
    pairs = [(t, p) for name, p in pred for t in by_name.get(name, ())]
    m = vqa_metrics([t for t, _ in pairs], [p for _, p in pairs])
    scores = dict(pred)

    acc_ns = acc_s = 0.0
    if rank_pairs is not None:
        acc_ns = pairwise_rank_accuracy(scores, _rank_pairs(rank_pairs,
                                                            "nonsource"))
        acc_s = pairwise_rank_accuracy(scores, _rank_pairs(rank_pairs,
                                                           "source"))

    return {
        "srcc": m.srcc,
        "plcc": m.plcc,
        "krcc": m.krcc,
        "rmse": m.rmse,
        "acc_nonsource": acc_ns,
        "acc_source": acc_s,
        "score": challenge_score(m.srcc, m.plcc, acc_ns, acc_s),
    }
