"""Batch preparation and device feeding for eval and training (counterpart
of the batch helpers of kvq_tpu/train/trainer.py:62-110, 143-148, 408-426
and of kvq_tpu/data/pipeline.py:device_prefetch).

Batches arrive in the JAX ``Loader``'s collated format: numpy arrays for
the views and scalars, lists for metadata (``video_name``, ``num_clips``).
An eval batch is padded to the eval batch size and clip-reshaped; a train
batch (``fragment``, ``resize_video``, ``label``, ``dis_label``) is neither
(:func:`train_host_tensors`).  Both are pre-cast on a worker thread
(:func:`prepared_in_background`) and copied ahead on a side stream
(:func:`prefetch_to_device`).
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

ARRAY_BATCH_KEYS = (
    "fragment", "resize_video", "simpleVQA", "technical", "aesthetic",
    "feat", "label", "dis_label", "sample_index",
)

# Image views a bf16 model casts to its dtype as its first op: shipping them
# pre-cast is bitwise-identical and halves the host-to-device bytes.
VIEW_CAST_KEYS = ("fragment", "resize_video", "simpleVQA", "technical",
                  "aesthetic")


def view_dtype(config: dict) -> torch.dtype | None:
    """Host pre-cast dtype of the image views: ``h2d_dtype`` when set
    (``bfloat16`` or ``float32`` only), else bf16 when the model computes
    in bf16."""
    h2d = config.get("h2d_dtype")
    if h2d is None:
        h2d = (config.get("model") or {}).get("compute_dtype") or "bfloat16"
        return torch.bfloat16 if h2d == "bfloat16" else None
    if h2d not in ("bfloat16", "float32"):
        raise ValueError(f"h2d_dtype must be 'bfloat16' or 'float32', "
                         f"got {h2d!r}")
    return torch.bfloat16 if h2d == "bfloat16" else None


def pad_batch_rows(batch: dict, target: int) -> dict:
    """Pad every leading-batch-dim field to ``target`` rows by repeating the
    last row; padded rows are dropped after scoring."""
    n = int(np.asarray(batch["label"]).reshape(-1).shape[0])
    if n >= target:
        return batch
    pad = target - n
    out: dict = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == n:
            out[k] = np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
        elif isinstance(v, list) and len(v) == n:
            out[k] = v + [v[-1]] * pad
        else:
            out[k] = v
    return out


def reshape_for_clips(batch: dict, keys) -> dict:
    """Reference eval reshape (trainer.py:188-201): split the temporal axis
    of each field named in ``keys`` into num_clips clips folded into the
    batch.  For KSVQE the key ("KSVQE") is not a batch field, so its 96
    eval frames run as one clip — a reference quirk, kept."""
    batch = dict(batch)
    nc_field = batch.get("num_clips")
    if isinstance(nc_field, list):
        nc_field = nc_field[0]
    for key in keys:
        if key in batch:
            v = batch[key]
            b, t = v.shape[0], v.shape[1]
            nc = (int(next(iter(nc_field.values())))
                  if isinstance(nc_field, dict) else int(nc_field or 1))
            if nc > 1:
                batch[key] = v.reshape(b * nc, t // nc, *v.shape[2:])
    return batch


def host_tensors(batch: dict, cast: torch.dtype | None,
                 pin: bool) -> dict[str, torch.Tensor]:
    """The array fields as host tensors, views pre-cast to ``cast``, in
    pinned memory when ``pin``."""
    out = {}
    for k in ARRAY_BATCH_KEYS:
        if k not in batch:
            continue
        src = torch.from_numpy(np.ascontiguousarray(batch[k]))
        dt = cast if (cast is not None and k in VIEW_CAST_KEYS) else src.dtype
        if pin:
            t = torch.empty(src.shape, dtype=dt, pin_memory=True)
            t.copy_(src)
        else:
            t = src.to(dt)
        out[k] = t
    return out


TRAIN_KEYS = ("fragment", "resize_video", "label", "dis_label")


def train_host_tensors(batch: dict, cast: torch.dtype | None,
                       pin: bool) -> dict[str, torch.Tensor]:
    """A train batch's array fields as host tensors (views pre-cast to
    ``cast``, pinned when ``pin``): no padding and no clip reshape."""
    missing = [k for k in TRAIN_KEYS if k not in batch]
    if missing:
        raise KeyError(f"train batch lacks {missing}")
    return host_tensors({k: batch[k] for k in TRAIN_KEYS}, cast, pin)


def prepared_in_background(prepare: Callable, items: Iterable,
                           depth: int = 2) -> Iterator:
    """``prepare(item)`` for each item, in order, on one worker thread up
    to ``depth`` items ahead: the casts release the interpreter lock, so
    they overlap the main thread's dispatch of the model."""
    with ThreadPoolExecutor(max_workers=1) as pool:
        ahead: collections.deque = collections.deque()
        for item in items:
            ahead.append(pool.submit(prepare, item))
            if len(ahead) > depth:
                yield ahead.popleft().result()
        while ahead:
            yield ahead.popleft().result()


def prefetch_to_device(items: Iterable, device: torch.device,
                       depth: int = 2) -> Iterator:
    """Yield ``(meta, device_tensors)`` for ``(meta, host_tensors)`` items,
    keeping ``depth`` host-to-device copies in flight on a side CUDA
    stream so the next batch's copy overlaps the current batch's compute.
    On the CPU the tensors pass through."""
    if device.type != "cuda":
        for meta, host in items:
            yield meta, host
        return
    copy_stream = torch.cuda.Stream(device)
    buf: collections.deque = collections.deque()

    def pop():
        meta, dev, done = buf.popleft()
        cur = torch.cuda.current_stream(device)
        cur.wait_event(done)
        for t in dev.values():
            t.record_stream(cur)
        return meta, dev

    for meta, host in items:
        with torch.cuda.stream(copy_stream):
            dev = {k: t.to(device, non_blocking=True) for k, t in host.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        buf.append((meta, dev, done))
        if len(buf) >= depth:
            yield pop()
    while buf:
        yield pop()
