"""The ledger of the port's kernel launches: which wrappers count, in order.

:data:`NAMES` is the ordered list of the counted kernel wrappers of
:mod:`.window_attention` (K1, K2, K3, K6, K7) and :mod:`.train_attention`
(K4 and K5, forward and backward).  Each registers itself once with
:func:`counted`, which starts its ``launches`` at 0; the wrapper adds one
per call that reaches the card.  A CUDA graph's replay launches its kernels
without the wrappers' Python, so the graphs (``nn/eval_graphs.py``) take a
capture's own calls back out (:func:`snapshot`, :func:`restore`) and add
each replay's (:func:`add`).
"""

from __future__ import annotations

import functools

NAMES = ("fused_swin_block", "flash_attention_nobias_cl",
         "flash_window_attention_packed", "flash_window_attention",
         "flash_attention_nobias", "train_swin_block", "train_swin_block_bwd",
         "window_attention_train", "window_attention_train_bwd")
_REGISTERED: dict = {}


def counted(fn):
    """Register ``fn``, one of :data:`NAMES`, once; its count starts at 0."""
    if fn.__name__ not in NAMES or fn.__name__ in _REGISTERED:
        raise ValueError(f"{fn.__name__} is not an unregistered name of "
                         f"NAMES")
    fn.launches = 0
    _REGISTERED[fn.__name__] = fn
    return fn


@functools.cache
def wrappers() -> tuple:
    """The counted wrappers, in the order of :data:`NAMES`."""
    from . import train_attention, window_attention  # noqa: F401  register
    return tuple(_REGISTERED[n] for n in NAMES)


def snapshot() -> list[int]:
    """Every wrapper's count, in order."""
    return [f.launches for f in wrappers()]


def restore(counts) -> None:
    """Set the counts back to a :func:`snapshot`."""
    for f, n in zip(wrappers(), counts):
        f.launches = n


def add(counts) -> None:
    """Add ``counts`` (in order) to the wrappers' counts."""
    for f, n in zip(wrappers(), counts):
        f.launches += n


def diff(before, after) -> list[int]:
    """The calls between two snapshots."""
    return [b - a for a, b in zip(before, after)]
