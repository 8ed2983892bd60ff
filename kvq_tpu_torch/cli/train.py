"""Training CLI (counterpart of kvq_tpu/cli/train.py), on one card or
data-parallel over N under torchrun:

    python -m kvq_tpu_torch.cli.train -o config/Kwai_KSVQE.yml \
        -t val -r ./work [--epochs N] [--resume_from work/KSVQE_last_state.pt]
    torchrun --standalone --nproc_per_node N -m kvq_tpu_torch.cli.train \
        -o config/Kwai_KSVQE.yml -r ./work

Builds the config's train and val Loaders and the
:class:`~kvq_tpu_torch.train.trainer.Trainer` (``steps_per_epoch`` = the
train Loader's batches, the best-weights files under ``-r``), then for each
epoch trains on ``train_loader.epoch(e)`` and evaluates the raw and EMA
weights on the val split (``Trainer.train_eval``), and writes the full
state to ``{name}_last_state.pt`` under ``-r``; ``--resume_from`` reads
such a file first, or the JAX trainer's ``_last_state.msgpack`` (the
weights, EMA, AdamW moments, schedule, step and best metrics; the port
still writes its own ``.pt``).  The config's ``load_path`` may name a
reference ``.pth``, a port ``.pt`` or a JAX msgpack file.

Under torchrun (``WORLD_SIZE`` in the environment) each process joins the
group (``parallel.init_distributed``: NCCL on ``cuda:LOCAL_RANK``, gloo on
the CPU), reads its own shard of both splits (``build_loaders``' default),
takes ``steps_per_epoch`` from its own train Loader and trains the DDP
step (``train/trainer.py``), which needs ``ddp: true`` in the config, as
config/Kwai_KSVQE.yml ships it; rank 0 alone prints and writes the files.
``--ddp`` is accepted for train_ddp.py compatibility and changes nothing:
the config's ``ddp`` decides, as in the JAX package.  ``--debug_nans``
turns on autograd's anomaly detection.  ``--log_dir DIR`` writes each
epoch's records (the ``train/`` loss terms, the ``val_n/`` best metrics;
printed either way) to ``DIR/{name}_metrics.jsonl``, as the JAX trainer
does under its workdir.  :func:`run` takes the config as a dict, for
callers without PyYAML.
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from ..core.config import load_config, normalize_config
from ..data.pipeline import build_loaders
from ..parallel import launch, rank
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
                   help="accepted for train_ddp.py compatibility; the "
                   "config's ddp key decides (launch with torchrun)")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly(True): raise "
                   "where a backward produces NaN (slow)")
    p.add_argument("--log_dir", default=None,
                   help="write each epoch's metric records to "
                   "{name}_metrics.jsonl here")
    p.add_argument("--device", default="cuda",
                   help="cuda (default: cuda:LOCAL_RANK under torchrun) or "
                   "cpu")
    return p.parse_args(argv)


def run(config: dict, workdir: str = "./work", test_set: str = "val",
        epochs: int | None = None, seed: int = 42,
        resume_from: str | None = None, device="cuda",
        log_dir: str | None = None) -> Trainer:
    """Train ``epochs`` epochs (else the config's ``num_epochs``); returns
    the trainer."""
    device = launch(device)
    config = normalize_config(config)
    os.makedirs(workdir, exist_ok=True)
    train_loader, val_loader = build_loaders(config)
    if train_loader is None or val_loader is None:
        raise ValueError("the config needs data.train and data.val splits")
    trainer = Trainer(config, device=device, seed=seed,
                      steps_per_epoch=len(train_loader), workdir=workdir,
                      test_set=test_set, log_dir=log_dir)
    main = rank() == 0
    if resume_from:
        trainer.load(resume_from)
        if main:
            print(f"resumed from {resume_from} at step {trainer.step}")
    state = os.path.join(workdir, f"{config['name']}_last_state.pt")
    for epoch in range(epochs or int(config["num_epochs"])):
        t0, step0 = time.perf_counter(), trainer.step
        # the val Loader is iterated afresh for the raw and the EMA weights
        best, best_ema = trainer.train_eval(train_loader.epoch(epoch),
                                            val_loader)
        trainer.save(state)
        if not main:
            continue
        s = time.perf_counter() - t0
        print(
            f"epoch {epoch} ({trainer.step - step0} steps a rank and the "
            f"evaluations in {s:.3f} s): step {trainer.step}, last losses "
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
    try:
        trainer = run(load_config(args.opt), args.resume, args.test_set,
                      args.epochs, args.seed, args.resume_from, args.device,
                      args.log_dir)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return trainer.best, trainer.best_ema


if __name__ == "__main__":
    main()
