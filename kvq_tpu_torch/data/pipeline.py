"""The host pipeline: batching, the threaded ``Loader`` and the loaders of a
config (counterpart of kvq_tpu/data/pipeline.py:31-162 and of
kvq_tpu/train/trainer.py:178-218), then batch preparation and device
feeding for eval and training (counterpart of the batch helpers of
kvq_tpu/train/trainer.py:62-110, 143-148, 408-426 and of
kvq_tpu/data/pipeline.py:device_prefetch).

The ``Loader`` yields collated batches: numpy arrays for the views and
scalars, lists for metadata (``video_name``, ``num_clips``).  An eval batch
is padded to the eval batch size and clip-reshaped; a train batch, the
fields its model keys read (:func:`train_fields`: KSVQE's ``fragment``,
``resize_video``, ``label``, ``dis_label``; SimpleVQA's ``simpleVQA``,
``feat``, ``label``; a Swin key's ``technical`` and ``label``), is neither (:func:`train_host_tensors`).  Both are pre-cast on
a worker thread (:func:`prepared_in_background`) and copied ahead on a
side stream (:func:`prefetch_to_device`).
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, Sequence

import numpy as np
import torch

from ..core.registry import DATASETS
from ..parallel.sharding import loader_shard
from . import datasets  # noqa: F401  (registers the dataset classes)

# fields collate stacks whatever their type (kvq_tpu/data/pipeline.py)
_COLLATE_ARRAY_KEYS = (
    "fragment",
    "resize_video",
    "ori_fragment",
    "simpleVQA",
    "technical",
    "aesthetic",
    "feat",
)


def collate(items: Sequence[dict]) -> dict[str, Any]:
    """Stack array fields, gather scalars into arrays, pass through meta."""
    out: dict[str, Any] = {}
    first = items[0]
    for k in first:
        v = first[k]
        if k in _COLLATE_ARRAY_KEYS or (isinstance(v, np.ndarray)
                                        and v.ndim >= 2):
            out[k] = np.stack([it[k] for it in items])
        elif isinstance(v, (int, np.integer)):
            out[k] = np.asarray([it[k] for it in items], dtype=np.int32)
        elif isinstance(v, (float, np.floating)):
            out[k] = np.asarray([it[k] for it in items], dtype=np.float32)
        else:
            out[k] = [it[k] for it in items]
    return out


class Loader:
    """Threaded batch loader over an indexable dataset
    (``dataset.__getitem__(index, epoch=...)``).

    ``epoch(e)`` yields the batches of epoch ``e`` in order, each made by
    one of ``num_workers`` threads (decode, views and collate are numpy and
    release the interpreter lock); at most ``2 * num_workers`` batches are
    made ahead of the consumer.  A worker's error is raised to the
    consumer.  ``shuffle`` permutes with ``default_rng((seed, epoch))``;
    ``drop_last`` drops a short last batch; ``shard`` = (index, count)
    takes every count-th sample of the list tiled to a multiple of count
    (torch's DistributedSampler, reference trainer_ddp.py:144-156), so every
    shard has as many batches.  Each batch's ``sample_index`` is the
    dataset positions of its samples.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        num_workers: int = 6,
        seed: int = 42,
        drop_last: bool = False,
        shard: tuple[int, int] = (0, 1),
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.shard = shard

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            idx = np.random.default_rng((self.seed, epoch)).permutation(n)
        k, world = self.shard
        if world > 1 and n > 0:
            # np.resize tiles, so every shard gets ceil(n / world) samples
            # even when the dataset is smaller than the world
            total = -(-n // world) * world
            idx = np.resize(idx, total)
        return idx[k::world]

    def __len__(self) -> int:
        n = len(self._epoch_indices(0))
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        indices = self._epoch_indices(epoch)
        batches = [
            indices[i : i + self.batch_size]
            for i in range(0, len(indices), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if not batches:
            return

        work: "queue.Queue[tuple[int, np.ndarray] | None]" = queue.Queue()
        for i, b in enumerate(batches):
            work.put((i, b))
        for _ in range(self.num_workers):
            work.put(None)
        done: dict[int, dict] = {}
        done_lock = threading.Condition()
        # a slot per batch taken and not yet consumed, so that a Loader
        # faster than its consumer holds a bounded number of batches (a KVQ
        # eval batch is ~110 MB); workers take tasks in order, so the batch
        # the consumer waits for always holds a slot
        slots = threading.Semaphore(2 * self.num_workers)
        stop = threading.Event()

        def worker():
            while True:
                slots.acquire()
                task = None if stop.is_set() else work.get()
                if task is None:
                    return
                i, idxs = task
                try:
                    items = [
                        self.dataset.__getitem__(int(j), epoch=epoch)
                        for j in idxs
                    ]
                    batch = collate(items)
                    batch["sample_index"] = np.asarray(idxs, np.int32)
                except Exception as e:  # raised to the consumer
                    batch = {"__error__": e}
                with done_lock:
                    done[i] = batch
                    done_lock.notify_all()

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(self.num_workers)
        ]
        for t in threads:
            t.start()

        try:
            for i in range(len(batches)):
                with done_lock:
                    while i not in done:
                        done_lock.wait()
                    batch = done.pop(i)
                slots.release()
                if "__error__" in batch:
                    raise batch["__error__"]
                yield batch
        finally:
            # let blocked workers see the stop and exit
            stop.set()
            for _ in threads:
                slots.release()

    def __iter__(self):
        return self.epoch(0)


def _s2d_input(config: dict) -> bool:
    """The model's ``backbone.s2d_input`` (a key's hypers and its backbone
    may be empty in the YAML, as config/kwai_simpleVQA.yml's are)."""
    model = config["model"]
    hypers = (model.get("args") or {}).get(model["type"]) or {}
    return bool((hypers.get("backbone") or {}).get("s2d_input", False))


def build_loaders(config: dict, shard: tuple[int, int] | None = None
                  ) -> tuple[Loader | None, Loader | None]:
    """``(train, val)`` Loaders of ``config['data']`` (None for a split the
    config lacks), as the JAX trainer builds them: the dataset class by its
    registered ``type``; the model's ``s2d_input`` asks both splits for
    s2d-packed fragments; train batches of ``batch_size``, shuffled by
    ``seed``, the short last one dropped; val batches of
    ``eval_batch_size`` (else 1), in order; ``num_workers`` threads; both
    read ``shard`` = (index, count) of the list, by default this rank's
    (``parallel.loader_shard()``: (0, 1) without a process group)."""
    if shard is None:
        shard = loader_shard()
    data_cfg = config["data"]
    nw = int(config.get("num_workers", 6))
    s2d = _s2d_input(config)

    def dataset(split):
        args = dict(data_cfg[split]["args"])
        if s2d:
            args["fragment_s2d"] = True
        return DATASETS.get(data_cfg[split]["type"])(args)

    train = val = None
    if "train" in data_cfg:
        train = Loader(dataset("train"), batch_size=int(config["batch_size"]),
                       shuffle=True, num_workers=nw,
                       seed=int(config.get("seed", 42)), drop_last=True,
                       shard=shard)
    if "val" in data_cfg:
        val = Loader(dataset("val"),
                     batch_size=int(config.get("eval_batch_size") or 1),
                     shuffle=False, num_workers=nw, shard=shard)
    return train, val


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


# The array fields a train step reads, by model key: KSVQE's views and its
# distortion labels; SimpleVQA's view and SlowFast features; a Swin-T-3D
# key's technical view.  Every key reads the label.
KSVQE_TRAIN_FIELDS = ("fragment", "resize_video", "label", "dis_label")
SIMPLEVQA_TRAIN_FIELDS = ("simpleVQA", "feat", "label")
SWIN_TRAIN_FIELDS = ("technical", "label")
_TRAIN_FIELDS = {"KSVQE": KSVQE_TRAIN_FIELDS,
                 "simpleVQA": SIMPLEVQA_TRAIN_FIELDS}


def train_fields(keys) -> tuple[str, ...]:
    """The batch fields a train step of the model keys ``keys`` reads."""
    fields: list[str] = []
    for key in keys:
        own = _TRAIN_FIELDS.get(key, SWIN_TRAIN_FIELDS)
        fields += [f for f in own if f not in fields]
    return tuple(fields)


def train_host_tensors(batch: dict, fields, cast: torch.dtype | None,
                       pin: bool) -> dict[str, torch.Tensor]:
    """A train batch's ``fields`` as host tensors (views pre-cast to
    ``cast``, pinned when ``pin``): no padding and no clip reshape."""
    missing = [k for k in fields if k not in batch]
    if missing:
        raise KeyError(f"train batch lacks {missing}")
    return host_tensors({k: batch[k] for k in fields}, cast, pin)


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
