"""The multi-device dry run and the compile-check forward (counterparts of
``entry`` and ``dryrun_multichip`` in the JAX package's root entry module,
__graft_entry__.py:63-86 and :88-292).

:func:`entry` is the tiny KSVQE's eval forward with its example batch.
:func:`dryrun_multichip` runs one step of each train flavour in a process
group of ``n`` ranks, on tiny shapes:

  1. the (data, fsdp) sharded step (``parallel/fsdp.py``) on (n/2, 2) (on
     (n, 1) when n is odd), the plain attention, a global batch of 2 rows a
     data row (one a rank at fsdp 2);
  2. the DDP step (the Trainer's DDP route) on (n, 1), 2 rows a rank;
  3. the kernel path (``use_pallas``: K4 and K5 in training, K1 and K2 at
     eval) under the sharded step, then one sharded eval forward.

Each must give a finite loss (finite scores) and ``step == 1``.  On the
CPU the kernels' plain versions run (JAX runs its kernels in interpret
mode there); on the card the kernels launch, and the model keeps the
shipped block geometry (``card=True``: widths 96 and 192 at head_dim 32,
(8, 7, 7) windows over the 9x9 mosaic of 32 px, 16 frames) so that every
block is one the kernels take.  ``python -m kvq_tpu_torch.parallel.dryrun
N [--device cpu]`` spawns the N ranks (gloo, a ``tcp://localhost``
rendezvous) and prints rank 0's line.
"""

from __future__ import annotations

import argparse
import math
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..models.vqa_network import build_model, build_train_model
from .fsdp import make_sharded_eval_step, make_sharded_train_step
from .mesh import init_distributed, make_mesh

# the JAX dry run's tiny KSVQE (__graft_entry__.py:_tiny_ksvqe_config)
TINY_BACKBONE = dict(
    num_samples=2, sample_type="topkpertubation", CLIP_location=8,
    cls_use=True, tuning_stage=1, a1=1, a2=2, checkpoint=False,
    anchor_size=8, region_k=9, depths=[1, 1], num_heads=[2, 2],
    embed_dim=16, window_size=[2, 7, 7], contrique_layers=[1, 1, 1, 1],
    clip_layers=2, clip_width=64, clip_heads=4)
TINY_SHAPES = (8, 40, 32)  # frames, fragment px, resize px
# on the card: the shipped blocks' widths, heads and windows, two stages
CARD_BACKBONE = dict(TINY_BACKBONE, embed_dim=96, num_heads=[3, 6],
                     anchor_size=32, region_k=49, window_size=[8, 7, 7])
CARD_SHAPES = (16, 288, 112)


def dryrun_config(use_pallas: bool = False, card: bool = False) -> dict:
    """The dry run's config: the tiny KSVQE + VQAHead, AdamW lr 3e-5 wd
    0.05 with 10 warmup steps of 100, the EMA; float32 on the CPU, the
    shipped bf16 on the card."""
    bb = dict(CARD_BACKBONE if card else TINY_BACKBONE, use_pallas=use_pallas)
    return {"name": "dryrun", "ema": True, "warmup_epochs": 10,
            "num_epochs": 100, "optimizer": {"lr": 3e-5, "wd": 0.05},
            "model": {"type": "KSVQE",
                      "compute_dtype": "bfloat16" if card else "float32",
                      "args": {"KSVQE": {"backbone": bb,
                                         "head": {"hidden_channels": 16}}}}}


def dryrun_batch(B: int, seed: int = 0, card: bool = False) -> dict:
    """A seeded numpy batch of ``B`` rows in the Loader's format."""
    T, frag, res = CARD_SHAPES if card else TINY_SHAPES
    rng = np.random.default_rng(seed)
    return {
        "fragment": rng.normal(size=(B, T, frag, frag, 3)).astype(np.float32),
        "resize_video": rng.normal(size=(B, T, res, res, 3)).astype(
            np.float32),
        "dis_label": np.asarray([i % 2 for i in range(B)], np.int32),
        "label": rng.normal(size=(B,)).astype(np.float32),
        "sample_index": np.arange(B),
    }


def entry(device="cuda"):
    """``(fn, (model, batch))``: the tiny KSVQE + VQAHead eval forward
    (seeded weights) and a batch of 2; ``fn(model, batch)`` returns the
    scores and the contrastive loss."""
    cfg = dryrun_config()
    model = build_model(cfg, device)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in dryrun_batch(2).items()}

    @torch.no_grad()
    def fn(model, batch):
        return model(batch, reduce_scores=True)

    return fn, (model, batch)


def _rows(batch: dict, part: int, parts: int, device) -> dict:
    b = len(batch["label"]) // parts
    return {k: torch.from_numpy(v[part * b:(part + 1) * b]).to(device)
            for k, v in batch.items() if k != "sample_index"}


def _finite(what: str, x: float) -> float:
    if not math.isfinite(x):
        raise AssertionError(f"dryrun {what} not finite: {x}")
    return x


def dryrun_multichip(n_devices: int, device="cuda", card: bool = False
                     ) -> dict:
    """One step of each flavour in the process group (of ``n_devices``
    ranks, joined already), on ``device``; returns the losses (the same on
    every rank) and the sharded eval's scores, and rank 0 prints them."""
    from ..train.trainer import Trainer

    if dist.get_world_size() != n_devices:
        raise ValueError(f"dryrun of {n_devices} ranks in a group of "
                         f"{dist.get_world_size()}")
    r = dist.get_rank()
    fsdp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(data=n_devices // fsdp, fsdp=fsdp)
    B = 2 * (n_devices // fsdp)
    batch = dryrun_batch(B, card=card)
    out = {"mesh": mesh.shape, "global_batch": B}

    # flavour 1: the (data, fsdp) sharded step
    cfg = dryrun_config(card=card)
    step, state = make_sharded_train_step(
        build_train_model(cfg, device), cfg, mesh, steps_per_epoch=1)
    aux = step(state, _rows(batch, r, n_devices, device))
    out["fsdp_loss"] = _finite("fsdp loss", float(aux["total_loss"]))
    assert state.step == 1

    # flavour 2: the DDP step on a pure-data layout
    ddp = Trainer(dict(cfg, ddp=True), device=device, seed=0)
    ddp_batch = dryrun_batch(2 * n_devices, seed=1, card=card)
    b = 2
    aux = ddp.train_step({k: v[r * b:(r + 1) * b]
                          for k, v in ddp_batch.items()})
    out["ddp_loss"] = _finite("ddp loss", aux["total_loss"])
    assert ddp.step == 1
    del ddp

    # flavour 3: the kernel path under the sharded step, then a sharded
    # eval forward
    pcfg = dryrun_config(use_pallas=True, card=card)
    pmodel = build_train_model(pcfg, device)
    pstep, pstate = make_sharded_train_step(pmodel, pcfg, mesh,
                                            steps_per_epoch=1)
    aux = pstep(pstate, _rows(batch, r, n_devices, device))
    out["kernel_path_loss"] = _finite("kernel-path loss",
                                      float(aux["total_loss"]))
    assert pstate.step == 1
    mine = {k: v[r * (B // n_devices):(r + 1) * (B // n_devices)]
            for k, v in batch.items()}
    _, scores, _ = make_sharded_eval_step(pmodel, pcfg)(pstate, [mine])
    if not all(map(math.isfinite, scores)) or len(scores) != B:
        raise AssertionError(f"dryrun sharded eval scores: {scores}")
    out["eval_scores"] = scores
    if r == 0:
        print(f"dryrun_multichip ok: fsdp mesh={mesh.shape} global_batch={B}"
              f" loss={out['fsdp_loss']:.4f} | ddp mesh={{'data': "
              f"{n_devices}, 'fsdp': 1}} global_batch={2 * n_devices} "
              f"loss={out['ddp_loss']:.4f} | kernel path fsdp train loss="
              f"{out['kernel_path_loss']:.4f} eval scores finite=True",
              flush=True)
    return out


def _rank_main(args) -> None:
    os.environ.update(RANK=str(args.rank), WORLD_SIZE=str(args.n),
                      LOCAL_RANK=str(args.rank))
    device = args.device
    if device == "cuda":  # ranks share the cards round-robin
        device = f"cuda:{args.rank % max(torch.cuda.device_count(), 1)}"
    dev = init_distributed(device, backend="gloo",
                           init_method=f"tcp://localhost:{args.port}")
    try:
        dryrun_multichip(args.n, dev, card=dev.type == "cuda")
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser("kvq_tpu_torch dryrun")
    p.add_argument("n", type=int, nargs="?", default=4)
    p.add_argument("--device", default="cuda")
    p.add_argument("--rank", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:
        _rank_main(args)
        return 0
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kvq_tpu_torch.parallel.dryrun", str(args.n),
         "--device", args.device, "--rank", str(r), "--port", str(port)])
        for r in range(args.n)]
    try:  # a rank that fails leaves the others waiting in a collective
        while any(q.poll() is None for q in procs) and not any(
                q.poll() for q in procs):
            time.sleep(0.2)
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
            q.wait()
    return max((q.returncode for q in procs), key=abs)


if __name__ == "__main__":
    sys.exit(main())
