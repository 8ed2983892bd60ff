"""Inference CLI (counterpart of kvq_tpu/cli/test.py):

    python -m kvq_tpu_torch.cli.test -o config/Kwai_KSVQE_test.yml \
        [-out output.txt] [--csv prediction.csv] [--device cpu] \
        [--trace_dir DIR]
    torchrun --standalone --nproc_per_node N -m kvq_tpu_torch.cli.test \
        -o config/Kwai_KSVQE_test.yml

Runs the config's ``data.val`` split through the port's dataset, the
``Loader`` and the :class:`~kvq_tpu_torch.train.evaluator.Evaluator` on the
card (``--device cpu`` only when asked), and writes ``video_name,score``
lines (reference trainer_ddp.py:316-352) and, with ``--csv``, the
prediction CSV of ``metric_score`` with its header.  The weights are
``test_load_path``'s, else ``load_path``'s: a reference ``.pth``, a port
``.pt``, or a file the JAX package wrote (``kvq_tpu.cli.convert``'s
output, a ``*_finetuned.msgpack``, or a full ``_last_state.msgpack``, of
which the params and batch_stats are taken), told apart by content.
Under torchrun each rank scores its own shard of the split and rank 0
writes the gathered rows, in the split's order (``train/evaluator.py``).
``--trace_dir DIR`` records the program's spans over the run, without the
profiler (``core/tracing.py``), writes them to ``DIR/spans.jsonl``
(``spans.rank<r>.jsonl`` under torchrun) and prints their summary.
:func:`run` takes the config as a dict, for callers without PyYAML.
"""

from __future__ import annotations

import argparse

import torch.distributed as dist

from ..core import tracing
from ..core.config import load_config, normalize_config
from ..data.pipeline import build_loaders
from ..parallel import launch, rank
from ..train.evaluator import Evaluator


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        "kvq_tpu_torch test",
        description="The weights are the config's test_load_path (else "
        "load_path): a torch file (.pth / .pt) or a JAX package msgpack "
        "file (converted weights, best weights or a full state).")
    p.add_argument("-o", "--opt", required=True, help="YAML config path")
    p.add_argument("-t", "--test_set", default="test", help="ignored")
    p.add_argument("--gpu_id", default="0", help="ignored (torch compat)")
    p.add_argument("-out", "--output", default="output.txt")
    p.add_argument("--csv", default=None, help="also write prediction csv")
    p.add_argument("--device", default="cuda",
                   help="cuda (default: cuda:LOCAL_RANK under torchrun) or "
                   "cpu")
    p.add_argument("--trace_dir", default=None,
                   help="record the program's spans and write them to "
                   "DIR/spans.jsonl (spans.rank<r>.jsonl under torchrun)")
    return p.parse_args(argv)


def run(config: dict, output: str = "output.txt", csv: str | None = None,
        device="cuda", trace_dir: str | None = None
        ) -> list[tuple[str, float]]:
    """Score the config's val split; returns ``(video_name, score)`` in
    the split's order (every rank's rows under torchrun)."""
    device = launch(device)
    config = normalize_config(config)
    _, val_loader = build_loaders(config)
    if val_loader is None:
        raise ValueError("the config has no data.val split to score")
    with tracing.recorded_to(trace_dir):
        evaluator = Evaluator(config, device=device)
        results = evaluator.inference_test(val_loader.epoch(0), output)
    if rank() != 0:
        return results
    if csv:
        with open(csv, "w") as f:
            f.write("filename,score\n")
            for name, score in results:
                f.write(f"{name},{score}\n")
    print(f"wrote {len(results)} predictions to {output}")
    return results


def main(argv=None):
    args = parse_args(argv)
    try:
        return run(load_config(args.opt), args.output, args.csv, args.device,
                   args.trace_dir)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
