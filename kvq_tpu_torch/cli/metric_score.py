"""Challenge scoring CLI (counterpart of kvq_tpu/cli/metric_score.py):

    python -m kvq_tpu_torch.cli.metric_score \
        --pred prediction.csv --truth truth.csv [--rank_pairs DIR_OR_XLSX]

Prints the JSON of :func:`~kvq_tpu_torch.core.metrics.
score_prediction_file`: SRCC, PLCC, KRCC, RMSE, the ranked-pair accuracies
and the challenge score.  ``--rank_pairs`` is a directory holding
``nonsource.csv`` and ``source.csv``, or an xlsx (read with openpyxl when
it is installed).
"""

from __future__ import annotations

import argparse
import json

from ..core.metrics import score_prediction_file


def main(argv=None):
    p = argparse.ArgumentParser("kvq_tpu_torch metric_score")
    p.add_argument("--pred", required=True)
    p.add_argument("--truth", required=True)
    p.add_argument("--rank_pairs", default=None)
    args = p.parse_args(argv)
    result = score_prediction_file(args.pred, args.truth, args.rank_pairs)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
