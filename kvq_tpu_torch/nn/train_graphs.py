"""KSVQE's train forward and backward replayed as CUDA graphs, split at QRS's
pick.

A train step of KSVQE launches ~4,600 kernels one by one from Python, and
on the card the host's launches take several times the card's own time.
:class:`TrainGraphs` captures each of the two segments that
``nn/eval_graphs.py`` splits the forward into as a forward graph and a
backward graph, all four in one private memory pool, and chains them by
autograd as ``torch.cuda.make_graphed_callables`` chains its callables:

- graph A: ``KSVQE.semantic_segment``: the casts of the views, the
  keyframes and CLIP with its trainable adapters;
- ``KSVQE.pick`` (eager): QRS's perturbed top-1, its draw and its own
  autograd node, on a copy of A's cls-attention;
- graph B: ``KSVQE.trunk_segment``: the weighted regions and the patch
  embed, CONTRIQUE, the contrastive loss, the Swin stages with K4 and K5,
  CDM and the final norm, on static DropPath multipliers;
- the backward: B's backward graph, the pick's backward (eager), A's
  backward graph.  Each returns its segment's gradients as static buffers,
  which autograd hands to the tensors' ``.grad`` (the caller reads them
  before the next step's backward replays).

The draws stay the eager forward's, from the caller's generator in its
order: QRS's draw (the pick), then each block's DropPath multipliers in
block order (``KSVQE.drop_path_draws``, copied into B's static buffers
before B replays), then whatever the caller draws after the backbone (the
head's dropout).  What a caller observes inside the forward is fresh, as
in the eager forward: the features and the loss are copies of B's outputs,
and ``select`` gets a copy of A's cls-attention.

:meth:`TrainGraphs.engages` decides from what it can observe: a training
module under autograd, CUDA input, no contrastive group and no module with
a ``process_group`` (a synced BatchNorm): its forward runs no collective.
A capture holds one input signature (``eval_graphs.signature``) and reads
the module's tensors at their addresses, so it holds only while they are
the captured objects there: a forward whose tensors are new every step
(the (data, fsdp) step's gathered tensors, or ``functional_call`` on fresh
casts) never captures.  A capture is made only where a forward sees the
same tensor objects at the same addresses as the forward before it; until
then, and wherever the rule declines, the forward is eager.

A capture's eager warm-up runs on a side stream with stand-ins for the
draws (a one-hot pick, DropPath multipliers from a private generator) and
``torch.autograd.grad`` for the backward: it consumes no draw of the
caller's generator, leaves every ``.grad`` as it was and restores the
module's buffers.  The kernel wrappers' ``launches`` count as eagerly: the
capture's own calls are taken back out, and each replay adds the calls its
graph captured.  Each graphed forward is one ``kvq.train.replay`` span
(``core/tracing.py``; attrs ``segments=2``), inside the Trainer's
``kvq.train.forward``; the backward replays fall inside its
``kvq.train.backward``.
"""

from __future__ import annotations

import contextlib
import weakref

import torch

from ..core.tracing import span
from ..ops import train_attention as ta
from . import eval_graphs as EG

_ENABLED = True  # False runs every forward eagerly (the card tests' baseline)
# the kernel wrappers whose ``launches`` the replays keep counting
COUNTED = EG.COUNTED + (ta.train_swin_block, ta.train_swin_block_bwd,
                        ta.window_attention_train,
                        ta.window_attention_train_bwd)


def _tensors(module) -> list:
    """(owner dict, name, tensor) of every parameter and buffer."""
    return [(owner, name, t) for m in module.modules()
            for owner in (m._parameters, m._buffers)
            for name, t in owner.items() if t is not None]


def _launches() -> list[int]:
    return [f.launches for f in COUNTED]


def _count(counts) -> None:
    for f, n in zip(COUNTED, counts):
        f.launches += n


class TrainGraphs:
    """A KSVQE module's train captures, one per input signature."""

    def __init__(self):
        self._captures: dict = {}
        self._pool = None  # the captures' memory pool
        # (weak reference, address) of each tensor of the last forward
        # that found no capture holding
        self._seen: list = []

    @staticmethod
    def engages(net, batch) -> bool:
        """Whether ``net``'s forward on ``batch`` may replay graphs."""
        return (_ENABLED and net.training and torch.is_grad_enabled()
                and net.contrastive_group is None
                and batch["fragment"].is_cuda
                and not any(getattr(m, "process_group", None) is not None
                            for m in net.modules()))

    def capture_for(self, net, batch) -> "Capture | None":
        """The capture for ``batch``'s signature: the one that holds, one
        made now if ``net``'s tensors are those the forward before saw,
        else None (the forward runs eagerly)."""
        sig = EG.signature(batch)
        cap = self._captures.get(sig)
        if cap is not None and cap.holds():
            return cap
        self._captures = {k: c for k, c in self._captures.items()
                          if c.holds()}
        tensors = [t for _, _, t in _tensors(net)]
        seen, self._seen = self._seen, [(weakref.ref(t), t.data_ptr())
                                        for t in tensors]
        if len(seen) != len(tensors) or any(
                ref() is not t or ptr != t.data_ptr()
                for (ref, ptr), t in zip(seen, tensors)):
            return None
        if not self._captures:  # a new pool, the old one's graphs gone
            self._pool = torch.cuda.graph_pool_handle()
        self._captures[sig] = cap = Capture(net, batch, self._pool)
        return cap

    def __call__(self, net, batch, gen):
        """The graphed forward, or None where it does not replay."""
        with torch.cuda.device(batch["fragment"].device):
            cap = self.capture_for(net, batch)
            if cap is None:
                return None
            with span("kvq.train.replay", segments=2):
                return cap.run(net, batch, gen)


class Capture:
    """One signature's four graphs, their static inputs, outputs and
    gradients, and the module's tensors they read."""

    def __init__(self, net, batch, pool):
        self.tensors = [(owner, name, t, t.data_ptr())
                        for owner, name, t in _tensors(net)]
        semantic = {id(t) for _, _, t in _tensors(net.CLIP_tool)}
        trained = list({id(t): t for _, _, t, _ in self.tensors
                        if t.requires_grad}.values())
        self.params_a = [t for t in trained if id(t) in semantic]
        self.params_b = [t for t in trained if id(t) not in semantic]
        self.inputs = {}
        for k in EG.FIELDS:
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

    @contextlib.contextmanager
    def _aliased(self):
        """The module's trained tensors swapped, for the warm-up or the
        capture, for leaves of their own on the same storage: a graph reads
        the same memory, and autograd's nodes of the real tensors (of any
        earlier step's graph still alive, or of the next) are neither made
        nor reached on another stream.  Yields (A's, B's) aliases."""
        alias = {id(t): t.detach().requires_grad_()
                 for t in (*self.params_a, *self.params_b)}
        swapped = [(owner, name, t) for owner, name, t, _ in self.tensors
                   if id(t) in alias]
        for owner, name, t in swapped:
            owner[name] = alias[id(t)]
        try:
            yield ([alias[id(t)] for t in self.params_a],
                   [alias[id(t)] for t in self.params_b])
        finally:
            for owner, name, t in swapped:
                owner[name] = t

    def _segments(self, net, graphs=None, pool=None):
        """Forward A, forward B, backward B, backward A, in the order they
        replay: eagerly, or each into its graph of ``graphs``.  A's
        outputs are B's inputs where they lie (the regions' fragment, the
        patch tokens as a leaf of their own); the pick is a stand-in."""
        with self._aliased() as (params_a, params_b):
            self._phases(net, params_a, params_b, graphs, pool)

    def _phases(self, net, params_a, params_b, graphs, pool):
        x = self.inputs
        counts = []

        def phase(i):
            if graphs is None:
                return contextlib.nullcontext()
            counts.append(_launches())
            # thread_local: other threads (the Trainer's worker, pinning
            # host memory) may call into CUDA while this one captures
            return torch.cuda.graph(graphs[i], pool=pool,
                                    capture_error_mode="thread_local")

        def backward(i, outs, inputs):
            diff = [o.requires_grad for o in outs]
            outs = [o for o in outs if o.requires_grad]
            grad_out = [torch.zeros_like(o) for o in outs]
            with phase(i):
                grads = (torch.autograd.grad(outs, inputs, grad_out,
                                             allow_unused=True)
                         if outs else ())
            return diff, grad_out, grads
        with phase(0):
            frag, cls_attn, pat = net.semantic_segment(x["fragment"],
                                                       x["resize_video"])
        sel = net.pick_stand_in(cls_attn, frag)
        pat_in = pat.detach().requires_grad_(pat.requires_grad)
        with phase(1):
            features, loss = net.trunk_segment(frag, sel, pat_in,
                                               x["dis_label"], dps=self.dps)
        b = backward(2, (features, loss), [sel, pat_in, *params_b])
        a = backward(3, (cls_attn, pat), params_a)
        if graphs is not None:
            counts.append(_launches())
            self.counts = [[n1 - n0 for n0, n1 in zip(c0, c1)]
                           for c0, c1 in zip(counts, counts[1:])]
            # the static tensors, without the capture's autograd graph
            self.fragment, self.cls_attn, self.pat, self.features, \
                self.loss = (t.detach() for t in (frag, cls_attn, pat,
                                                   features, loss))
            self.sel = sel
            self.diff_b, self.grad_out_b, self.grads_b = b
            self.diff_a, self.grad_out_a, self.grads_a = a

    def _capture(self, net, pool):
        """Warm the four phases up eagerly on a side stream (lazy state:
        the kernels' builds, the libraries' handles, the cached
        constants), the module's buffers restored after, then capture each
        into ``pool``.  The DropPath buffers hold a private generator's
        draws until a replay copies the caller's in."""
        dev = self.inputs["fragment"].device
        own = torch.Generator(device=dev).manual_seed(0)
        self.dps = net.drop_path_draws(self.inputs["fragment"].shape[0],
                                       own, dev)
        self.dp_static = [d for stage in self.dps for pair in stage
                          for d in pair if d is not None]
        buffers = [(b, b.clone()) for m in net.modules()
                   for b in m._buffers.values() if b is not None]
        start = _launches()
        try:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._segments(net)
            torch.cuda.current_stream(dev).wait_stream(side)
            with torch.no_grad():
                for b, v in buffers:
                    b.copy_(v)
            self.graphs = [torch.cuda.CUDAGraph() for _ in range(4)]
            self._segments(net, self.graphs, pool)
        finally:
            for f, n in zip(COUNTED, start):
                f.launches = n

    def run(self, net, batch, gen):
        """One training forward: ``batch`` into the static inputs, graph A,
        the pick on a copy of A's cls-attention, the DropPath draws into
        B's buffers, graph B; autograd replays the backward graphs.
        Returns (features, the contrastive loss), copies of B's outputs."""
        for k, t in self.inputs.items():
            t.copy_(batch[k])
        cls_attn, pat = _SegmentA.apply(self, *self.params_a)
        sel = net.pick(cls_attn, self.fragment, gen)
        if (sel.shape, sel.dtype) != (self.sel.shape, self.sel.dtype):
            raise ValueError(f"QRS's pick {tuple(sel.shape)} {sel.dtype} is "
                             f"not the captured {tuple(self.sel.shape)} "
                             f"{self.sel.dtype}")
        drawn = [d for stage in net.drop_path_draws(
            self.sel.shape[0], gen, sel.device) for pair in stage
            for d in pair if d is not None]
        if self.dp_static:
            torch._foreach_copy_(self.dp_static, drawn)
        return _SegmentB.apply(self, sel, pat, *self.params_b)


def _into(statics, diff, grads) -> None:
    """The incoming gradients of the differentiable outputs into the static
    buffers a backward graph reads (no copy where autograd hands over the
    buffer itself)."""
    for s, g in zip(statics, (g for g, d in zip(grads, diff) if d)):
        if s.data_ptr() != g.data_ptr():
            s.copy_(g)


def _outputs(ctx, outs, diff) -> tuple:
    ctx.mark_non_differentiable(*(o for o, d in zip(outs, diff) if not d))
    return outs


def _detached(grads) -> tuple:
    return tuple(None if g is None else g.detach() for g in grads)


# The segments' trained tensors are inputs of these Functions only so that
# autograd routes their gradients (the backward graphs' static buffers) to
# them; the graphs read them where they lie.
class _SegmentA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cap, *params):
        cap.graphs[0].replay()
        _count(cap.counts[0])
        ctx.cap = cap
        return _outputs(ctx, (cap.cls_attn.clone(), cap.pat.detach()),
                        cap.diff_a)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        cap = ctx.cap
        _into(cap.grad_out_a, cap.diff_a, grads)
        cap.graphs[3].replay()
        _count(cap.counts[3])
        return (None, *_detached(cap.grads_a))


class _SegmentB(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cap, sel, pat, *params):
        cap.sel.copy_(sel)  # ``pat`` is A's static output, where B reads it
        cap.graphs[1].replay()
        _count(cap.counts[1])
        ctx.cap = cap
        return _outputs(ctx, (cap.features.clone(), cap.loss.clone()),
                        cap.diff_b)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        cap = ctx.cap
        _into(cap.grad_out_b, cap.diff_b, grads)
        cap.graphs[2].replay()
        _count(cap.counts[2])
        return (None, *_detached(cap.grads_b))
