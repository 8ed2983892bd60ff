"""The eval half of the JAX ``Trainer`` (kvq_tpu/train/trainer.py:465-547,
571-627, 674-719).

``Evaluator(config)`` builds the eval network (seeded random weights,
cast to the compute dtype) and merges the weights of ``test_load_path``,
else ``load_path``, when the config names one, as kvq_tpu/cli/test.py:32-34
resolves them (core/checkpoint.py:merge_state_dict); a model passed in is
used as it is.  ``evaluate(batches)`` returns
:class:`~kvq_tpu_torch.core.metrics.VQAMetrics` of the per-video scores
against the labels; ``inference_test(batches, output_path)`` writes
``video_name,score`` lines.  Batch N+1's padding,
bf16 pre-cast (on a worker thread) and host-to-device copy are in flight
while batch N is scored, and batch N's scores are read back only after
batch N+1 has been dispatched.

In a data-parallel run (a process group of more than one rank) each rank
scores its own Loader shard; ``evaluate`` and ``inference_test`` then
gather every rank's rows by their ``sample_index`` (the Loader stamps it)
and drop the shard wrap's duplicates (``parallel/steps.py:gather_rows``),
so every rank gets the metrics of the whole split, and rank 0 alone writes
``output.txt``, in dataset-index order: the one-process order of a val
Loader, which does not shuffle.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from ..core.checkpoint import load_weights
from ..core.config import key_list, normalize_config
from ..core.device import resolve_device
from ..core.metrics import VQAMetrics, vqa_metrics
from ..data.pipeline import (
    host_tensors,
    pad_batch_rows,
    prefetch_to_device,
    prepared_in_background,
    reshape_for_clips,
    view_dtype,
)
from ..models.vqa_network import build_model
from ..parallel.mesh import rank, world
from ..parallel.steps import gather_rows


class Evaluator:
    def __init__(self, config: dict, model=None, device="cuda", seed: int = 0):
        self.config = normalize_config(config)
        self.device = resolve_device(device)
        if model is None:
            model = build_model(self.config, self.device, seed)
            path = (self.config.get("test_load_path")
                    or self.config.get("load_path"))
            if path:
                load_weights(model, path)
        self.model = model
        self.key_list = key_list(self.config)
        self.cast = view_dtype(self.config)
        self.eval_batch_size = int(self.config.get("eval_batch_size") or 1)
        self.depth = max(1, int(self.config.get("eval_pipeline_depth", 2)))

    def _prepare(self, batch: dict):
        n = int(np.asarray(batch["label"]).reshape(-1).shape[0])
        padded = pad_batch_rows(batch, self.eval_batch_size)
        rb = reshape_for_clips(padded, self.key_list)
        return (batch, n), host_tensors(rb, self.cast,
                                        pin=self.device.type == "cuda")

    def _collect(self, n: int, out) -> list[float]:
        per_video = (out.float().cpu().numpy()
                     .reshape(self.eval_batch_size, -1).mean(axis=1))
        return per_video[:n].tolist()

    @torch.no_grad()
    def scored_batches(self, batches: Iterable[dict]) -> Iterator:
        """Yield ``(batch, n_valid, per-video scores)`` in input order."""
        self.model.eval()
        pending = []
        for (batch, n), dev in prefetch_to_device(
            prepared_in_background(self._prepare, batches, self.depth),
            self.device, self.depth,
        ):
            out = self.model(dev, reduce_scores=True)
            if isinstance(out, tuple):
                out = out[0]
            pending.append((batch, n, out))
            if len(pending) >= self.depth:
                b, n0, o = pending.pop(0)
                yield b, n0, self._collect(n0, o)
        for b, n0, o in pending:
            yield b, n0, self._collect(n0, o)

    def _columns(self, batches: Iterable[dict], field: str) -> tuple:
        """(dataset indices, scores, ``field``'s values) of every scored
        video; the indices (the batches' ``sample_index``, which the Loader
        stamps) only in a data-parallel run, which gathers by them."""
        index, scores, values = [], [], []
        multi = world() > 1
        for batch, n, p in self.scored_batches(batches):
            scores.extend(p)
            v = batch[field]
            values.extend(list(v)[:n] if field == "video_name" else
                          np.asarray(v, np.float64).reshape(-1)[:n].tolist())
            if multi:
                if "sample_index" not in batch:
                    raise ValueError(
                        "a data-parallel eval needs batches with "
                        "'sample_index' (the Loader stamps it)")
                index.extend(np.asarray(batch["sample_index"])[:n].tolist())
        return index, scores, values

    def evaluate(self, batches: Iterable[dict]) -> VQAMetrics:
        index, preds, labels = self._columns(batches, "label")
        if world() > 1:
            _, preds, labels = gather_rows(index, preds, labels)
        return vqa_metrics(labels, preds)

    def inference_test(self, batches: Iterable[dict],
                       output_path: str = "output.txt") -> list:
        index, scores, names = self._columns(batches, "video_name")
        if world() > 1:
            named: list[dict] = [None] * world()
            dist.all_gather_object(named, dict(zip(index, names)))
            name_of = {i: v for d in named for i, v in d.items()}
            index, scores = gather_rows(index, scores)
            names = [name_of[i] for i in index]
        results = list(zip(names, scores))
        if rank() == 0:
            with open(output_path, "w") as f:
                for name, score in results:
                    f.write(f"{name},{score}\n")
        return results
