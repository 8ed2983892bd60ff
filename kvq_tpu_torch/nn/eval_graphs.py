"""KSVQE's forward replayed as CUDA graphs split at QRS's pick: the mechanism
and the eval capture.

A KSVQE forward launches ~1,500 kernels from Python (a train step ~4,600),
which take the host longer than the card takes to run them.  A
:class:`Graphs` cache captures the forward's segments once per input
signature (each field's shape, strides, dtype and device) as CUDA graphs in
one private pool, and replays them on every later forward:

- graph A, ``KSVQE.semantic_segment``: the casts, the keyframes and CLIP;
- ``KSVQE.pick`` (eager): QRS's ``RegionSelector.select`` on a copy of A's
  cls-attention;
- graph B, ``KSVQE.trunk_segment``: the picked regions, the patch embed,
  CONTRIQUE, the contrastive loss, the Swin stages, CDM and the final norm;
  the forward returns copies of its features and loss, so hooks and a
  patched ``select`` see fresh tensors of each forward, as eagerly.

A capture kind says what its graphs are and how a forward runs them
(:class:`EvalCapture`, ``train_graphs.TrainCapture``); :func:`engages` picks
the kind.  A capture reads the module's parameters and buffers at their
addresses: ``load_state_dict`` in place reaches the next replay; a tensor
replaced (``assign=True``, ``.to()``) drops the captures and the next
forward captures anew.  A cache's captures share its pool, opened anew once
all were dropped; each kind has its own cache, so eval and train graphs
never share a pool.  The device constants the segments read
(``core/device.py:index_tensor``, ``ops/window_attention.py:_token_ids_on``
and the like) are cached for the process: no graph reads memory freed under
it.  The wrappers' ``launches`` (``ops/launches.py``) count as eagerly: a
capture's own calls are taken back out, each replay adds its graph's.  Each
graphed forward is one span (``core/tracing.py``; attrs ``segments=2``):
``kvq.graph.replay`` at eval, ``kvq.train.replay`` in training.
"""

from __future__ import annotations

import contextlib

import torch

from ..core.tracing import span
from ..ops import launches

_ENABLED = True  # False runs every forward eagerly (the card tests' baseline)
FIELDS = ("fragment", "resize_video", "dis_label")  # what the backbone reads


def signature(batch) -> tuple:
    """What a capture is made for: each field's shape, strides, dtype and
    device."""
    return tuple((tuple(t.shape), t.stride(), t.dtype, t.device)
                 for t in (batch[k] for k in FIELDS))


def tensors(module) -> list:
    """(owner dict, name, tensor) of every parameter and buffer."""
    return [(owner, name, t) for m in module.modules()
            for owner in (m._parameters, m._buffers)
            for name, t in owner.items() if t is not None]


def engages(net, batch) -> str | None:
    """The graphs ``net``'s forward on ``batch`` replays: "eval" (an eval
    module, no autograd) or "train" (training under autograd, no module with
    a ``process_group``: no collective), on CUDA input with no contrastive
    group (the loss of this forward's own rows); None: it runs eagerly."""
    if not (_ENABLED and net.contrastive_group is None
            and batch["fragment"].is_cuda):
        return None
    if not net.training and not torch.is_grad_enabled():
        return "eval"
    if net.training and torch.is_grad_enabled() and not any(
            getattr(m, "process_group", None) is not None
            for m in net.modules()):
        return "train"
    return None


class Graphs:
    """A KSVQE module's captures of one kind, one per input signature."""

    def __init__(self, kind):
        self.kind = kind  # a Capture subclass
        self._captures: dict = {}
        self._pool = None  # the captures' memory pool

    def capture_for(self, net, batch) -> "Capture | None":
        """The capture for ``batch``'s signature: the one that holds, else
        one made now where the kind admits it (which drops every capture
        whose tensors have moved), else None."""
        sig = signature(batch)
        cap = self._captures.get(sig)
        if cap is not None and cap.holds():
            return cap
        self._captures = {k: c for k, c in self._captures.items()
                          if c.holds()}
        if not self.kind.admits(net):
            return None
        if not self._captures:  # a new pool, the old one's graphs gone
            self._pool = torch.cuda.graph_pool_handle()
        self._captures[sig] = cap = self.kind(net, batch, self._pool)
        return cap

    def __call__(self, net, batch, gen=None):
        """The graphed forward, or None where it does not replay."""
        with torch.cuda.device(batch["fragment"].device):
            cap = self.capture_for(net, batch)
            if cap is None:
                return None
            with span(self.kind.SPAN, segments=2):
                return cap.run(net, batch, gen)


class Capture:
    """One signature's graphs, their static inputs, and the module's tensors
    they read.  A kind makes its graphs in ``_capture`` (by
    :meth:`_record` of its ``_segments``) and replays them in ``run``."""

    def __init__(self, net, batch, pool):
        self.tensors = [(owner, name, t, t.data_ptr())
                        for owner, name, t in tensors(net)]
        self.inputs = {k: torch.empty_strided(
            batch[k].shape, batch[k].stride(), dtype=batch[k].dtype,
            device=batch[k].device) for k in FIELDS}
        self.stage(batch)
        self._capture(net, pool)

    @classmethod
    def admits(cls, net) -> bool:
        """Whether a capture may be made now, where none holds."""
        return True

    def holds(self) -> bool:
        """Whether the module still holds the tensors captured, at their
        addresses."""
        return all(owner.get(name) is t and t.data_ptr() == ptr
                   for owner, name, t, ptr in self.tensors)

    def _record(self, net, pool, n):
        """``_segments`` warmed up eagerly on a side stream (the kernels'
        builds, the libraries' handles, the cached constants), the module's
        buffers put back as they were, then its ``n`` phases captured into
        graphs of ``pool``; ``self.counts`` keeps each graph's own calls,
        the launch counts as they were.  Returns the capture's."""
        dev = self.inputs["fragment"].device
        buffers = [(b, b.clone()) for b in net.buffers()]
        marks, start = [], launches.snapshot()
        self.graphs = [torch.cuda.CUDAGraph() for _ in range(n)]

        def phase(i):
            marks.append(launches.snapshot())
            # thread_local: other threads (the Evaluator's or the Trainer's
            # worker, pinning host memory) may call into CUDA meanwhile
            return torch.cuda.graph(self.graphs[i], pool=pool,
                                    capture_error_mode="thread_local")
        try:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._segments(net, lambda i: contextlib.nullcontext())
            torch.cuda.current_stream(dev).wait_stream(side)
            with torch.no_grad():
                for b, v in buffers:
                    b.copy_(v)
            out = self._segments(net, phase)
            marks.append(launches.snapshot())
        finally:
            launches.restore(start)
        self.counts = [launches.diff(a, b) for a, b in zip(marks, marks[1:])]
        return out

    def replay(self, i) -> None:
        """Graph ``i``, its captured calls counted."""
        self.graphs[i].replay()
        launches.add(self.counts[i])

    def stage(self, batch) -> None:
        """``batch`` into the static inputs."""
        for k, t in self.inputs.items():
            t.copy_(batch[k])


class EvalCapture(Capture):
    """An eval forward's two graphs, A and B, and the pick between them."""

    SPAN = "kvq.graph.replay"

    def _capture(self, net, pool):
        """The pick is a region index per frame, (B, T) int64 at eval;
        region 0 stands in for it while warming up and capturing."""
        f = self.inputs["fragment"]
        self.pick = torch.zeros((f.shape[0], net._frames(f)),
                                dtype=torch.int64, device=f.device)
        (self.fragment, self.cls_attn, self.pat, self.features,
         self.loss) = self._record(net, pool, 2)

    def _segments(self, net, phase):
        x = self.inputs
        with phase(0):
            frag, cls_attn, pat = net.semantic_segment(x["fragment"],
                                                       x["resize_video"])
        with phase(1):
            features, loss = net.trunk_segment(frag, self.pick, pat,
                                               x["dis_label"])
        return frag, cls_attn, pat, features, loss

    def run(self, net, batch, gen=None):
        """One forward: ``batch`` into the static inputs, graph A, the pick
        on a copy of A's cls-attention, graph B; copies of B's outputs."""
        self.stage(batch)
        self.replay(0)
        self.pick.copy_(net.pick(self.cls_attn.clone(), self.fragment))
        self.replay(1)
        return self.features.clone(), self.loss.clone()
