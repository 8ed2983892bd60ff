"""Device resolution for the port's entry points, and constant index
tensors."""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def index_tensor(values: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """``values`` as an int64 tensor on ``device``, made once.  Copying a
    new index tensor from pageable host memory in every forward would make
    the host wait for the card's queue to drain.  Kept for the process: a
    captured CUDA graph (``nn/eval_graphs.py``) reads it by address."""
    return torch.as_tensor(values, dtype=torch.int64, device=device)


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  CUDA is the default; without it
    the caller must ask for the CPU explicitly — no entry point drops to
    the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
