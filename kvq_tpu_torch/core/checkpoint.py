"""Full train-state checkpoints of the port (counterpart of the JAX
trainer's save_full_state / load_full_state, kvq_tpu/train/trainer.py:
279-332): parameters, optimizer and schedule state, EMA parameters, step
and best metrics, in one ``torch.save`` file.  Resume works between runs of
the port; the JAX package's msgpack checkpoints do not load here."""

from __future__ import annotations

import os

import torch


def save_checkpoint(path: str, state: dict) -> None:
    """Write ``state`` atomically (to a temporary name, then renamed)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, device="cpu") -> dict:
    return torch.load(path, map_location=device, weights_only=True)
