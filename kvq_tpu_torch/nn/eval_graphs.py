"""KSVQE's eval forward replayed as two CUDA graphs, split at QRS's pick.

An eval forward of KSVQE launches ~1,500 kernels one by one from Python,
and on the card the host's launches take about twice the card's own time.
:class:`EvalGraphs` captures the forward's two segments once, as CUDA graphs
in one private memory pool, and replays them on every later forward: the
same kernels in the same order, launched by the graph instead of the host.

- ``KSVQE.semantic_segment`` (graph A): the casts, the keyframes and CLIP;
- ``KSVQE.pick`` (eager): QRS's pick, ``RegionSelector.select``, on a copy
  of A's cls-attention, copied into B's input;
- ``KSVQE.trunk_segment`` (graph B): the picked regions and the patch
  embed, CONTRIQUE, the contrastive loss, the Swin stages with K1, CDM with
  K2 and the final norm; the backbone returns copies of its features and
  loss.

So what a caller observes inside a forward (the model's and the head's
hooks, a patched ``select``) are calls on fresh tensors of that forward, as
in the eager forward.

:meth:`EvalGraphs.engages` decides from what it can observe: an eval module
(not ``training``) under no autograd, CUDA input and no contrastive group
(the loss of this forward's own rows, no collective); anything else runs the
eager forward.  A capture holds one input signature (each field's shape,
strides, dtype and device) and reads the module's parameters and buffers at
their addresses: weights loaded in place (``load_state_dict``) are read by
the next replay, and a tensor replaced (``load_state_dict(assign=True)``,
``.to()``) drops the captures, so that the next forward captures anew.

A module's captures share one memory pool.  A forward replays its own two
graphs back to back and keeps nothing in the pool past its end (the
outputs are copied out), so a capture may reuse what another capture's
graphs use in between: each new signature adds its static tensors to the
pool, not a second set of intermediates.  The device constants the segments
read are the port's cached ones (``core/device.py:index_tensor``,
``ops/window_attention.py:_token_ids_on`` and the like), made once and kept
for the process: a graph never reads memory freed under it.

The kernel wrappers' ``launches`` count the calls of the module's forwards,
as eagerly: a capture's calls (its eager warm-up, whose result is dropped,
and the capture itself) are taken back out, and each replay adds the calls
its segment captured.  Each graphed forward is one ``kvq.graph.replay`` span
(``core/tracing.py``; attrs ``segments=2``).
"""

from __future__ import annotations

import torch

from ..core.tracing import span
from ..ops import window_attention as wa

_ENABLED = True  # False runs every forward eagerly (the card tests' baseline)
FIELDS = ("fragment", "resize_video", "dis_label")  # what the backbone reads
# the eval kernels' wrappers, whose ``launches`` the replays keep counting
COUNTED = (wa.fused_swin_block, wa.flash_attention_nobias_cl,
           wa.flash_window_attention_packed, wa.flash_window_attention,
           wa.flash_attention_nobias)


def signature(batch) -> tuple:
    """What a capture is made for: each field's shape, strides, dtype and
    device."""
    return tuple((tuple(t.shape), t.stride(), t.dtype, t.device)
                 for t in (batch[k] for k in FIELDS))


def _launches() -> list[int]:
    return [f.launches for f in COUNTED]


class EvalGraphs:
    """A KSVQE module's captures, one per input signature."""

    def __init__(self):
        self._captures: dict = {}
        self._pool = None  # the captures' memory pool

    @staticmethod
    def engages(net, batch) -> bool:
        """Whether ``net``'s forward on ``batch`` replays graphs."""
        return (_ENABLED and not net.training
                and not torch.is_grad_enabled()
                and net.contrastive_group is None
                and batch["fragment"].is_cuda)

    def capture_for(self, net, batch) -> "Capture":
        """The capture for ``batch``'s signature, made now if there is none
        or if ``net``'s tensors have moved since (which drops every capture
        that reads them)."""
        sig = signature(batch)
        cap = self._captures.get(sig)
        if cap is not None and cap.holds():
            return cap
        self._captures = {k: c for k, c in self._captures.items()
                          if c.holds()}
        if not self._captures:  # a new pool, the old one's graphs gone
            self._pool = torch.cuda.graph_pool_handle()
        self._captures[sig] = cap = Capture(net, batch, self._pool)
        return cap

    def __call__(self, net, batch):
        with torch.cuda.device(batch["fragment"].device):
            cap = self.capture_for(net, batch)
            with span("kvq.graph.replay", segments=2):
                return cap.replay(net, batch)


class Capture:
    """One signature's two graphs, their static inputs and outputs, and the
    module's tensors they read."""

    def __init__(self, net, batch, pool):
        self.tensors = [(owner, name, t, t.data_ptr())
                        for m in net.modules()
                        for owner in (m._parameters, m._buffers)
                        for name, t in owner.items() if t is not None]
        self.inputs = {}
        for k in FIELDS:
            t = batch[k]
            self.inputs[k] = torch.empty_strided(
                t.shape, t.stride(), dtype=t.dtype, device=t.device)
            self.inputs[k].copy_(t)
        self._capture(net, pool)

    def holds(self) -> bool:
        """Whether the module still holds the tensors captured, at their
        addresses."""
        return all(owner.get(name) is t and t.data_ptr() == ptr
                   for owner, name, t, ptr in self.tensors)

    def _capture(self, net, pool):
        """Warm both segments up eagerly on a side stream (lazy state: the
        kernels' builds and attributes, the libraries' handles, the cached
        constants), then capture each into ``pool``.  The pick is a
        region index per frame, (B, T) int64 at eval; region 0 stands in
        for it while warming up and capturing."""
        x = self.inputs
        dev = x["fragment"].device
        self.pick = torch.zeros((x["fragment"].shape[0],
                                 net._frames(x["fragment"])),
                                dtype=torch.int64, device=dev)
        start = _launches()
        try:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                fragment, _, pat = net.semantic_segment(x["fragment"],
                                                        x["resize_video"])
                net.trunk_segment(fragment, self.pick, pat, x["dis_label"])
                del fragment, pat
            torch.cuda.current_stream(dev).wait_stream(side)
            self.a, self.b = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
            before = _launches()
            # thread_local: other threads (the Evaluator's worker, pinning
            # host memory) may call into CUDA while this one captures
            with torch.cuda.graph(self.a, pool=pool,
                                  capture_error_mode="thread_local"):
                self.fragment, self.cls_attn, self.pat = \
                    net.semantic_segment(x["fragment"], x["resize_video"])
            mid = _launches()
            with torch.cuda.graph(self.b, pool=pool,
                                  capture_error_mode="thread_local"):
                self.features, self.loss = net.trunk_segment(
                    self.fragment, self.pick, self.pat, x["dis_label"])
            after = _launches()
        finally:
            for f, n in zip(COUNTED, start):
                f.launches = n
        self.counts_a = [m - b for m, b in zip(mid, before)]
        self.counts_b = [a - m for a, m in zip(after, mid)]

    def replay(self, net, batch):
        """One forward: ``batch`` into the static inputs, graph A, the pick
        on a copy of A's cls-attention, graph B; copies of B's outputs."""
        for k, t in self.inputs.items():
            t.copy_(batch[k])
        self.a.replay()
        _count(self.counts_a)
        self.pick.copy_(net.pick(self.cls_attn.clone(), self.fragment))
        self.b.replay()
        _count(self.counts_b)
        return self.features.clone(), self.loss.clone()


def _count(counts) -> None:
    for f, n in zip(COUNTED, counts):
        f.launches += n
