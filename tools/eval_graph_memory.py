"""The card's memory while KSVQE trains with evaluation between epochs (what
``cli.train``'s train_eval does), for comparing two checkouts.

``Trainer`` at chip_smoke's ``TRAIN_CONFIG`` (the shipped B=4, T=32 train
view): one epoch of 4 steps, ``Trainer.evaluate`` with the raw and the EMA
weights over 4 score batches (B=1, T=96), another epoch, another
evaluation; then the eval model's backbone at two more input signatures
(B=1 bf16, B=2).  After each phase one JSON line: reserved and allocated
GiB, their peaks, the phase's seconds.  The CUDA graphs of KSVQE's eval
forward (``nn/eval_graphs.py``) keep their pool for the model's life, so
the second epoch shows what that pool costs beside training.

Run from the root of a checkout, on a CUDA device:
    python tools/eval_graph_memory.py LABEL
"""

import json
import sys
import time

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from kvq_tpu_torch.train.trainer import Trainer  # noqa: E402

label = sys.argv[1]
G = 2 ** 30


def mem(tag, **kw):
    torch.cuda.synchronize()
    print(json.dumps(dict(
        side=label, tag=tag,
        reserved_gib=torch.cuda.memory_reserved() / G,
        allocated_gib=torch.cuda.memory_allocated() / G,
        peak_reserved_gib=torch.cuda.max_memory_reserved() / G,
        peak_allocated_gib=torch.cuda.max_memory_allocated() / G, **kw)),
        flush=True)


rng = np.random.default_rng(1)
train = [cs.make_train_batch(rng, i) for i in range(8)]
val = [cs.make_batch(rng, i) for i in range(4)]
tr = Trainer(cs.TRAIN_CONFIG, device="cuda", seed=0, steps_per_epoch=100)
t0 = time.perf_counter()
tr.train_epoch(train[:4])
mem("epoch 1 (no evaluation yet)", s=time.perf_counter() - t0)
t0 = time.perf_counter()
m1 = tr.evaluate(val)
m2 = tr.evaluate(val, use_ema=True)
mem("after evaluate raw + EMA", s=time.perf_counter() - t0,
    metrics=[str(m1)[:80], str(m2)[:80]])
torch.cuda.reset_peak_memory_stats()
t0 = time.perf_counter()
tr.train_epoch(train[4:])
mem("epoch 2 (peaks since the evaluation)", s=time.perf_counter() - t0)
t0 = time.perf_counter()
tr.evaluate(val)
mem("evaluate again", s=time.perf_counter() - t0)
model = tr._evaluator.model
b1 = {k: torch.as_tensor(np.asarray(val[0][k])).cuda()
      for k in ("fragment", "resize_video", "dis_label")}
b1["fragment"] = b1["fragment"].to(torch.bfloat16)
b1["resize_video"] = b1["resize_video"].to(torch.bfloat16)
b2 = {k: torch.cat([v, v]) for k, v in b1.items()}
before = torch.cuda.memory_reserved() / G
with torch.no_grad():
    model.KSVQE_backbone(b1)
    mem("backbone at B=1 bf16 (a third signature if the Evaluator's differs)")
    model.KSVQE_backbone(b2)
    mem("backbone at B=2 (another signature)",
        added_gib=torch.cuda.memory_reserved() / G - before)
print(label, "done", flush=True)
