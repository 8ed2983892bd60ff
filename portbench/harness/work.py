"""Work counts from the cell's shapes, on the reference: the operations
of a whole forward or train step, and each Swin kernel's operations and
bytes, with the card's published peaks.

The counts belong to the benchmark, not to the program, so a later change
to a kernel or to the model code leaves them as they are.  A model's
operations are counted by ``torch.utils.flop_counter`` over the reference
on the ``meta`` device (no memory, no time): the products of the forward,
and for a train step its backward as the reference computes it (frozen
parts get no weight gradients; no recompute).  A kernel's bound counts
each input byte read once and each output byte written once, and its
products' operations (chip_smoke.py's ``block_case``, ``k4_case`` and
``k5_case`` counts, copied).
"""

from __future__ import annotations

import functools
import json

import torch

# H100 SXM published dense peaks (NVIDIA H100 datasheet), at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_s(nbytes: float, flops: float) -> float:
    """The least time of a kernel: the larger of its bytes over the peak
    bandwidth and its operations over the peak bf16 rate."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS)


def meta_batch(mix: dict) -> dict:
    b = int(mix["batch_size"])
    out = {}
    for field, spec in mix["fields"].items():
        dt = torch.float32 if spec["law"] == "normal" else torch.int64
        out[field] = torch.zeros((b, *spec["shape"]), dtype=dt,
                                 device="meta")
    return out


@functools.lru_cache(maxsize=8)
def _model_flops(block_json: str, mix_json: str, train: bool) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    from ..reference.network import Network, is_frozen

    block, mix = json.loads(block_json), json.loads(mix_json)
    with torch.device("meta"):
        net = Network(block)
    net.train(train)
    for n, p in net.named_parameters():
        p.requires_grad_(train and not is_frozen(net.key, n))
    batch = meta_batch(mix)
    with FlopCounterMode(display=False) as counter:
        with torch.set_grad_enabled(train):
            scores, dis = net(batch)  # meta draws: no generator
            if train:
                loss = scores.sum() + (0 if dis is None else dis)
                loss.backward()
    return float(counter.get_total_flops())


def model_flops(config: dict, mix: dict, train: bool) -> float:
    """Operations of one forward (``train`` False) or one train step of
    the mix's batch."""
    return _model_flops(json.dumps(config["model"], sort_keys=True),
                        json.dumps(mix, sort_keys=True), train)


def swin_block_cost(batch: int, dims, window, C: int, heads: int,
                    frag: bool) -> tuple[float, float, float, float]:
    """(forward operations, forward bytes, backward operations, backward
    bytes) of one fused Swin block (K1 at eval, K4 in training) over a
    pad-free token volume ``dims``."""
    N = window[0] * window[1] * window[2]
    BW = batch * (dims[0] // window[0]) * (dims[1] // window[1]) * (
        dims[2] // window[2])
    flops = 2 * BW * N * (12 * C * C) + 4 * BW * heads * N * N * (C // heads)
    planes = (1 + int(frag)) * heads * N * N * 4
    w = 12 * C * C
    fwd_bytes = 2 * BW * N * C * 2 + w * 2 + planes
    bwd_bytes = 3 * BW * N * C * 2 + w * 2 + w * 4 + 2 * planes + 2 * BW * 4
    return flops, fwd_bytes + 2 * BW * 4, 3 * flops, bwd_bytes


def window_attention_cost(batch: int, dims, window, heads: int, hd: int,
                          frag: bool) -> tuple[float, float, float, float]:
    """The same four counts of K5's window attention over a padded token
    volume ``dims``."""
    N = window[0] * window[1] * window[2]
    BW = batch * (dims[0] // window[0]) * (dims[1] // window[1]) * (
        dims[2] // window[2])
    planes = (1 + int(frag)) * heads * N * N * 4
    flops = 4 * BW * heads * N * N * hd
    fwd_bytes = 4 * BW * heads * N * hd * 2 + planes + BW * heads * N * 4
    bwd_bytes = 8 * BW * heads * N * hd * 2 + 2 * planes + BW * heads * N * 4
    return flops, fwd_bytes, 2.5 * flops, bwd_bytes


@functools.lru_cache(maxsize=8)
def _swin_stages(block_json: str, mix_json: str, train: bool) -> tuple:
    from ..reference.network import Network
    from ..reference.swin import BasicLayer, get_window_size

    block, mix = json.loads(block_json), json.loads(mix_json)
    with torch.device("meta"):
        net = Network(block)
    net.train(train)
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda m, args: seen.append((m, tuple(args[0].shape))))
        for m in net.modules() if isinstance(m, BasicLayer)]
    with torch.no_grad():
        net(meta_batch(mix))  # meta draws: no generator
    for h in hooks:
        h.remove()
    out = []
    for layer, (b, *dims, c) in seen:
        blk = layer.blocks[0]
        win, _ = get_window_size(dims, blk.window_size, (0, 0, 0))
        pad = tuple(-(-d // w) * w for d, w in zip(dims, win))
        out.append({"batch": b, "dims": tuple(dims), "padded": pad,
                    "window": tuple(win), "C": c,
                    "heads": blk.attn.num_heads, "frag": blk.frag_bias,
                    "depth": len(layer.blocks)})
    return tuple(out)


def swin_stages(config: dict, mix: dict) -> list[dict]:
    """The Swin trunk's stages as the reference runs them at the mix's
    shapes (a forward on the meta device; in train mode for a train mix):
    for each, the rows, the token volume, the padded one, the window, C,
    heads, fragment bias and depth."""
    return list(_swin_stages(json.dumps(config["model"], sort_keys=True),
                             json.dumps(mix, sort_keys=True),
                             mix["entry"] == "train"))
