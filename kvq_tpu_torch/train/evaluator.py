"""The eval half of the JAX ``Trainer`` (kvq_tpu/train/trainer.py:465-547,
603-627, 674-719), single process.

``evaluate(batches)`` returns :class:`~kvq_tpu_torch.core.metrics.VQAMetrics`
of the per-video scores against the labels; ``inference_test(batches,
output_path)`` writes ``video_name,score`` lines.  Batch N+1's padding,
bf16 pre-cast (on a worker thread) and host-to-device copy are in flight
while batch N is scored, and batch N's scores are read back only after
batch N+1 has been dispatched.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np
import torch

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


class Evaluator:
    def __init__(self, config: dict, model=None, device="cuda", seed: int = 0):
        self.config = normalize_config(config)
        self.device = resolve_device(device)
        self.model = (model if model is not None
                      else build_model(self.config, self.device, seed))
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

    def evaluate(self, batches: Iterable[dict]) -> VQAMetrics:
        preds, labels = [], []
        for batch, n, p in self.scored_batches(batches):
            preds.extend(p)
            lab = np.asarray(batch["label"], np.float64).reshape(-1)
            labels.extend(lab[:n].tolist())
        return vqa_metrics(labels, preds)

    def inference_test(self, batches: Iterable[dict],
                       output_path: str = "output.txt") -> list:
        results = []
        for batch, n, p in self.scored_batches(batches):
            results.extend(zip(list(batch["video_name"])[:n], p))
        with open(output_path, "w") as f:
            for name, score in results:
                f.write(f"{name},{score}\n")
        return results
