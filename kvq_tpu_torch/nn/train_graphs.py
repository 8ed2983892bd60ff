"""KSVQE's train forward and backward replayed as CUDA graphs: the train
capture of ``nn/eval_graphs.py``'s mechanism.

Segments A and B are a forward and a backward graph each (B with K4 and K5
on static DropPath multipliers), chained by autograd as
``torch.cuda.make_graphed_callables`` chains its callables: B's backward,
the pick's (eager), A's, inside ``kvq.train.backward``.  Each hands its
segment's gradients to the tensors' ``.grad`` from static buffers, which
the caller reads before the next step's backward replays.  The draws stay
the eager forward's, from the caller's generator in its order: QRS's pick,
each block's DropPath multipliers (``KSVQE.drop_path_draws``, copied into
B's buffers), then the caller's own (the head's dropout).

A capture is made only where a forward sees the same tensor objects at the
same addresses as the forward before it: a forward whose tensors are new
every step (the (data, fsdp) step's gathered ones) runs eagerly.  The
warm-up uses stand-ins for the draws and ``torch.autograd.grad``: it draws
nothing from the caller's generator, leaves every ``.grad`` as it was and
restores the module's buffers.
"""

from __future__ import annotations

import contextlib
import weakref

import torch

from .eval_graphs import Capture, tensors

_SEEN = weakref.WeakKeyDictionary()  # module -> its last train forward's


class TrainCapture(Capture):
    """A training forward's four graphs, static outputs and gradients."""

    SPAN = "kvq.train.replay"

    @classmethod
    def admits(cls, net) -> bool:
        """Whether ``net``'s tensors are the objects, at the addresses, that
        the forward before this one saw."""
        now = [t for _, _, t in tensors(net)]
        seen = _SEEN.get(net, [])
        _SEEN[net] = [(weakref.ref(t), t.data_ptr()) for t in now]
        return len(seen) == len(now) and all(
            ref() is t and ptr == t.data_ptr()
            for (ref, ptr), t in zip(seen, now))

    @contextlib.contextmanager
    def _aliased(self):
        """The trained tensors swapped, for the warm-up or the capture, for
        leaves of their own on the same storage: a graph reads the same
        memory, and autograd's nodes of the real tensors (of an earlier
        step's graph still alive, or of the next) are neither made nor
        reached on another stream.  Yields (A's, B's) aliases."""
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

    def _capture(self, net, pool):
        """The trained tensors split between A (CLIP's) and B; the DropPath
        buffers hold a private generator's draws until a replay copies the
        caller's in."""
        semantic = {id(t) for _, _, t in tensors(net.CLIP_tool)}
        trained = list({id(t): t for _, _, t, _ in self.tensors
                        if t.requires_grad}.values())
        self.params_a = [t for t in trained if id(t) in semantic]
        self.params_b = [t for t in trained if id(t) not in semantic]
        dev = self.inputs["fragment"].device
        own = torch.Generator(device=dev).manual_seed(0)
        self.dps = net.drop_path_draws(self.inputs["fragment"].shape[0],
                                       own, dev)
        self.dp_static = [d for stage in self.dps for pair in stage
                          for d in pair if d is not None]
        outs, self.sel, b, a = self._record(net, pool, 4)
        # the static tensors, without the capture's autograd graph
        self.fragment, self.cls_attn, self.pat, self.features, self.loss = (
            t.detach() for t in outs)
        self.diff_b, self.grad_out_b, self.grads_b = b
        self.diff_a, self.grad_out_a, self.grads_a = a

    def _segments(self, net, phase):
        """Forward A, forward B, backward B, backward A, in replay order; A's
        outputs are B's inputs where they lie (the patch tokens as a leaf of
        their own); the pick is a stand-in."""
        x = self.inputs

        def backward(i, outs, inputs):
            diff = [o.requires_grad for o in outs]
            outs = [o for o in outs if o.requires_grad]
            grad_out = [torch.zeros_like(o) for o in outs]
            with phase(i):
                grads = (torch.autograd.grad(outs, inputs, grad_out,
                                             allow_unused=True)
                         if outs else ())
            return diff, grad_out, grads
        with self._aliased() as (params_a, params_b):
            with phase(0):
                frag, cls_attn, pat = net.semantic_segment(
                    x["fragment"], x["resize_video"])
            sel = net.pick_stand_in(cls_attn, frag)
            pat_in = pat.detach().requires_grad_(pat.requires_grad)
            with phase(1):
                features, loss = net.trunk_segment(
                    frag, sel, pat_in, x["dis_label"], dps=self.dps)
            b = backward(2, (features, loss), [sel, pat_in, *params_b])
            a = backward(3, (cls_attn, pat), params_a)
        return (frag, cls_attn, pat, features, loss), sel, b, a

    def run(self, net, batch, gen):
        """One training forward: ``batch`` into the static inputs, graph A,
        the pick on a copy of A's cls-attention, the DropPath draws into
        B's buffers, graph B; autograd replays the backward graphs.
        Returns (features, the contrastive loss), copies of B's outputs."""
        self.stage(batch)
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


def _outputs(ctx, outs, diff) -> tuple:
    ctx.mark_non_differentiable(*(o for o, d in zip(outs, diff) if not d))
    return outs


def _backward(cap, i, grads, statics, diff, out) -> tuple:
    """The incoming gradients of the differentiable outputs into the static
    buffers backward graph ``i`` reads (no copy where autograd hands over
    the buffer itself), graph ``i``, then its static gradients ``out``."""
    for s, g in zip(statics, (g for g, d in zip(grads, diff) if d)):
        if s.data_ptr() != g.data_ptr():
            s.copy_(g)
    cap.replay(i)
    return (None, *(None if g is None else g.detach() for g in out))


# The segments' trained tensors are inputs of these Functions only so that
# autograd routes their gradients (the backward graphs' static buffers) to
# them; the graphs read them where they lie.
class _SegmentA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cap, *params):
        cap.replay(0)
        ctx.cap = cap
        return _outputs(ctx, (cap.cls_attn.clone(), cap.pat.detach()),
                        cap.diff_a)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        c = ctx.cap
        return _backward(c, 3, grads, c.grad_out_a, c.diff_a, c.grads_a)


class _SegmentB(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cap, sel, pat, *params):
        cap.sel.copy_(sel)  # ``pat`` is A's static output, where B reads it
        cap.replay(1)
        ctx.cap = cap
        return _outputs(ctx, (cap.features.clone(), cap.loss.clone()),
                        cap.diff_b)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        c = ctx.cap
        return _backward(c, 2, grads, c.grad_out_b, c.diff_b, c.grads_b)
