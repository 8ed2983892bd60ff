"""Weights and traffic from ``--seed``.

Both are drawn on the run's device from ``torch.Generator`` objects seeded
from the seed, in a few large calls: the same seed gives the same weights
and inputs on the same kind of device.

Weights: one state dict for the reference and the program alike, under
the reference checkpoints' names.  Products (every parameter of two or
more dimensions) are lecun-normal, the position-bias tables truncated
normal(0.02), CLIP's class and position embeddings normal(0.02, 0.01),
norm gains 1 + normal(0.02), biases normal(0.02), BatchNorm statistics
mean 0 and variance 1; KSVQE's stage mixers ``a1`` and ``a2`` take the
values the configuration states.

Traffic: a mix file lists the fields of a batch row, each with its shape
and law (``normal``: standard normal float32; ``randint``: integers in
[0, high)), the batch size and the number of distinct batches in the pool
(``pool``).  The pool is drawn once, in set-up, and cycled by the window.
"""

from __future__ import annotations

import torch

MASK63 = 2 ** 63 - 1


def weight_seed(seed: int) -> int:
    return (2 * seed) & MASK63


def input_seed(seed: int) -> int:
    return (2 * seed + 1) & MASK63


def state_shapes(model: torch.nn.Module) -> dict:
    """name -> (shape, kind) of every parameter and BatchNorm statistic."""
    out = {n: (tuple(p.shape), "param") for n, p in model.named_parameters()}
    for n, b in model.named_buffers():
        leaf = n.rsplit(".", 1)[-1]
        if leaf in ("running_mean", "running_var", "num_batches_tracked"):
            out[n] = (tuple(b.shape), leaf)
    return out


def make_state_dict(shapes: dict, block: dict, seed: int, device) -> dict:
    """The seeded state dict of :func:`state_shapes` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(weight_seed(seed))
    params = [(n, s) for n, (s, k) in shapes.items() if k == "param"]
    total = sum(int(torch.Size(s).numel()) for _, s in params)
    noise = torch.randn(total, generator=gen, device=device)
    bb = next(iter(block["args"].values())).get("backbone") or {}
    sd, at = {}, 0
    for name, shape in params:
        n = int(torch.Size(shape).numel())
        z = noise[at:at + n].view(shape)
        at += n
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("a1", "a2"):
            val = float(bb.get(leaf, 1.0 if leaf == "a1" else 0.0))
            sd[name] = torch.full(shape, val, device=device)
        elif name.endswith("position_bias_table"):
            sd[name] = (z * 0.02).clamp(-0.04, 0.04)
        elif leaf == "class_embedding":
            sd[name] = z * 0.02
        elif leaf == "positional_embedding":
            sd[name] = z * 0.01
        elif len(shape) >= 2:
            sd[name] = z * (n // shape[0]) ** -0.5
        elif leaf == "weight":
            sd[name] = 1.0 + 0.02 * z
        else:
            sd[name] = 0.02 * z
    for name, (shape, kind) in shapes.items():
        if kind == "running_mean":
            sd[name] = torch.zeros(shape, device=device)
        elif kind == "running_var":
            sd[name] = torch.ones(shape, device=device)
        elif kind == "num_batches_tracked":
            sd[name] = torch.zeros(shape, dtype=torch.long, device=device)
    return sd


def make_pool(mix: dict, seed: int, device) -> list[dict]:
    """The mix's pool of host batches (the Loader's collated format)."""
    import numpy as np

    gen = torch.Generator(device=device).manual_seed(input_seed(seed))
    b, pool = int(mix["batch_size"]), int(mix["pool"])
    rows = b * pool
    drawn = {}
    for field, spec in mix["fields"].items():
        shape = (rows, *spec["shape"])
        if spec["law"] == "normal":
            t = torch.randn(shape, generator=gen, device=device)
        elif spec["law"] == "randint":
            t = torch.randint(0, int(spec["high"]), shape, generator=gen,
                              device=device, dtype=torch.int32)
        else:
            raise ValueError(f"unknown law {spec['law']!r} of {field!r}")
        drawn[field] = t.cpu().numpy()
    batches = []
    for i in range(pool):
        batch = {f: np.ascontiguousarray(v[i * b:(i + 1) * b])
                 for f, v in drawn.items()}
        batch["video_name"] = [f"pool_{i:03d}_{r}.mp4" for r in range(b)]
        for key, value in (mix.get("meta") or {}).items():
            batch[key] = [value] * b
        batches.append(batch)
    return batches
