"""Training CLI (counterpart of kvq_tpu/cli/train.py), one process on one
card:

    python -m kvq_tpu_torch.cli.train -o config/Kwai_KSVQE.yml \
        -t val -r ./work [--epochs N] [--resume_from work/KSVQE_last_state.pt]

Builds the config's train and val Loaders and the
:class:`~kvq_tpu_torch.train.trainer.Trainer` (``steps_per_epoch`` = the
train Loader's batches, the best-weights files under ``-r``), then for each
epoch trains on ``train_loader.epoch(e)`` and evaluates the raw and EMA
weights on the val split (``Trainer.train_eval``), and writes the full
state to ``{name}_last_state.pt`` under ``-r``; ``--resume_from`` reads
such a file first, or the JAX trainer's ``_last_state.msgpack`` (the
weights, EMA, AdamW moments, schedule, step and best metrics; the port
still writes its own ``.pt``).  The config's ``load_path`` may name a
reference ``.pth``, a port ``.pt`` or a JAX msgpack file.  ``--ddp`` is accepted and runs one process, as the JAX
package does with one device; ``--debug_nans`` turns on autograd's anomaly
detection.  :func:`run` takes the config as a dict, for callers without
PyYAML.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..core.config import load_config, normalize_config
from ..core.device import resolve_device
from ..data.pipeline import build_loaders
from ..train.trainer import Trainer


def parse_args(argv=None):
    p = argparse.ArgumentParser("kvq_tpu_torch train")
    p.add_argument("-o", "--opt", required=True, help="YAML config path")
    p.add_argument("-t", "--test_set", default="val")
    p.add_argument("-r", "--resume", default="./work", help="checkpoint dir")
    p.add_argument("--gpu_id", default="0", help="ignored (torch compat)")
    p.add_argument("--local_rank", type=int, default=0, help="ignored")
    p.add_argument("--epochs", type=int, default=None, help="override")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--resume_from", default=None,
                   help="full train state to resume: the port's "
                   "_last_state.pt or the JAX package's _last_state.msgpack "
                   "(told apart by content)")
    p.add_argument("--ddp", action="store_true",
                   help="accepted for train_ddp.py compatibility; one "
                   "process trains on one card")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly(True): raise "
                   "where a backward produces NaN (slow)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def run(config: dict, workdir: str = "./work", test_set: str = "val",
        epochs: int | None = None, seed: int = 42,
        resume_from: str | None = None, device="cuda") -> Trainer:
    """Train ``epochs`` epochs (else the config's ``num_epochs``); returns
    the trainer."""
    device = resolve_device(device)
    config = normalize_config(config)
    os.makedirs(workdir, exist_ok=True)
    train_loader, val_loader = build_loaders(config)
    if train_loader is None or val_loader is None:
        raise ValueError("the config needs data.train and data.val splits")
    trainer = Trainer(config, device=device, seed=seed,
                      steps_per_epoch=len(train_loader), workdir=workdir,
                      test_set=test_set)
    if resume_from:
        trainer.load(resume_from)
        print(f"resumed from {resume_from} at step {trainer.step}")
    state = os.path.join(workdir, f"{config['name']}_last_state.pt")
    for epoch in range(epochs or int(config["num_epochs"])):
        # the val Loader is iterated afresh for the raw and the EMA weights
        best, best_ema = trainer.train_eval(train_loader.epoch(epoch),
                                            val_loader)
        trainer.save(state)
        print(
            f"epoch {epoch}: step {trainer.step}, last losses "
            f"{trainer.last_losses}; best SRCC/PLCC/KRCC/RMSE "
            f"= {best[0]:.4f}/{best[1]:.4f}/{best[2]:.4f}/{best[3]:.4f} | "
            f"ema {best_ema[0]:.4f}/{best_ema[1]:.4f}/"
            f"{best_ema[2]:.4f}/{best_ema[3]:.4f}"
        )
    return trainer


def main(argv=None):
    args = parse_args(argv)
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    trainer = run(load_config(args.opt), args.resume, args.test_set,
                  args.epochs, args.seed, args.resume_from, args.device)
    return trainer.best, trainer.best_ema


if __name__ == "__main__":
    main()
