"""K4's forward keeps the intermediates its backward reads, and the backward
runs no forward of its own (kvq_tpu_torch/ops/train_attention.py), on the
CPU's plain versions.  The card's kernels are held to the same in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from kvq_tpu_torch.core import tracing
from kvq_tpu_torch.ops import train_attention as TA
from kvq_tpu_torch.ops import window_attention as TWA

GEOMETRIES = [
    ((4, 14, 14), (1, 3, 3), True),
    ((4, 14, 14), (0, 0, 0), False),
]


def _block(dims, shift, use_frag, C=16, h=2, seed=0):
    """A block's leaves (x, rel, frag and the weights, each requiring
    grad), its geometry and DropPath multipliers, and a cotangent."""
    rng = np.random.default_rng(seed)
    geo = TWA.WindowGeometry(batch=1, dims=dims, window=(2, 7, 7),
                             shift=shift, fragments=(1, 7, 7), num_heads=h,
                             head_dim=C // h, use_frag=use_frag)
    BW, N = geo.n_windows, geo.n_tokens

    def r(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale)
                                .astype(np.float32)).requires_grad_()

    params = {
        "norm1_scale": r(C, scale=0.1), "norm1_bias": r(C, scale=0.1),
        "qkv_w": r(3 * C, C, scale=0.3), "qkv_b": r(3 * C, scale=0.1),
        "proj_w": r(C, C, scale=0.3), "proj_b": r(C, scale=0.1),
        "norm2_scale": r(C, scale=0.1), "norm2_bias": r(C, scale=0.1),
        "fc1_w": r(4 * C, C, scale=0.3), "fc1_b": r(4 * C, scale=0.1),
        "fc2_w": r(C, 4 * C, scale=0.2), "fc2_b": r(C, scale=0.1),
    }
    x, rel = r(BW, N, C), r(h, N, N)
    frag = r(h, N, N) if use_frag else None
    dp1 = torch.where(torch.arange(BW) % 3 == 1, 0.0, 1.25)
    dp2 = torch.full((BW,), 1.25)
    dout = torch.from_numpy(rng.normal(size=(BW, N, C)).astype(np.float32))
    leaves = [x, rel, *params.values()] + ([frag] if use_frag else [])
    return x, params, rel, frag, geo, dp1, dp2, dout, leaves


def _counting(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return fn(*args, **kwargs)
    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("dims,shift,use_frag", GEOMETRIES)
def test_backward_runs_no_block_forward(monkeypatch, dims, shift, use_frag):
    """The forward runs the plain block forward once (one LayerNorm pair,
    one window attention); the backward runs none of it."""
    x, params, rel, frag, geo, dp1, dp2, dout, leaves = _block(
        dims, shift, use_frag)
    calls = {}
    _counting(monkeypatch, TA, "fused_swin_block_plain", calls)
    _counting(monkeypatch, TWA, "window_attention_plain", calls)
    _counting(monkeypatch, TWA, "layer_norm", calls)
    y = TA.train_swin_block(x, params, rel, frag, geo, dp1, dp2)
    assert calls == {"fused_swin_block_plain": 1,
                     "window_attention_plain": 1, "layer_norm": 2}
    calls.clear()
    grads = torch.autograd.grad(y, leaves, dout)
    assert calls == {}
    assert all(g is not None and bool(g.isfinite().all()) for g in grads)


@pytest.mark.parametrize("dims,shift,use_frag", GEOMETRIES)
def test_kept_bytes_are_the_saved_intermediates(dims, shift, use_frag):
    """``kept_bytes`` on the ``kvq.k4.fwd`` span is what the Function saved
    beyond its inputs; a forward that no backward can follow keeps nothing
    and its span carries no ``kept_bytes``."""
    x, params, rel, frag, geo, dp1, dp2, _, _ = _block(dims, shift, use_frag)
    with tracing.recording():
        since = tracing.mark()
        y = TA.train_swin_block(x, params, rel, frag, geo, dp1, dp2)
        with torch.no_grad():
            z = TA.train_swin_block(x, params, rel, frag, geo, dp1, dp2)
        spans = [s for s in tracing.spans(since) if s["name"] == "kvq.k4.fwd"]
    inputs = {t.data_ptr() for t in (x, rel, frag, dp1, dp2,
                                     *params.values()) if t is not None}
    saved = [t for t in y.grad_fn.saved_tensors
             if t is not None and t.data_ptr() not in inputs]
    assert len(saved) == len(TA.KEPT) - 1  # no log-sum-exp on the CPU
    assert spans[0]["attrs"] == {
        "kept_bytes": sum(t.numel() * t.element_size() for t in saved)}
    assert spans[0]["attrs"]["kept_bytes"] == TA.kept_bytes(x, params, geo)
    assert z.grad_fn is None and spans[1]["attrs"] == {}
    assert torch.equal(y.detach(), z)


@pytest.mark.parametrize("use_frag", [True, False])
def test_checkpointed_stage_runs_each_block_forward_twice(monkeypatch,
                                                          use_frag):
    """A K4 stage (``BasicLayer`` with ``use_pallas``) under
    ``use_checkpoint=True`` (non-reentrant ``torch.utils.checkpoint``,
    which drops what K4 kept and recomputes it) gives the gradients of the
    stage without it, and runs each block's forward twice a step (the
    forward and remat's recompute), against once without remat."""
    from kvq_tpu_torch.nn.swin import BasicLayer

    torch.manual_seed(0)
    layers = [BasicLayer(16, 2, 2, (2, 7, 7), frag_bias=use_frag,
                         use_pallas=True, downsample=False,
                         use_checkpoint=ck).train() for ck in (False, True)]
    layers[1].load_state_dict(layers[0].state_dict())
    x = torch.randn(1, 4, 14, 14, 16, generator=torch.Generator()
                    .manual_seed(1))
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
    calls = {}
    _counting(monkeypatch, TA, "fused_swin_block_plain", calls)
    _counting(monkeypatch, TWA, "window_attention_plain", calls)
    runs, counts = [], []
    for layer in layers:
        calls.clear()
        xi = x.clone().requires_grad_()
        layer(xi, gen=torch.Generator().manual_seed(3)).backward(dy)
        counts.append(dict(calls))
        runs.append([xi.grad] + [p.grad for p in layer.parameters()])
    assert counts == [{"fused_swin_block_plain": 2,
                       "window_attention_plain": 2},
                      {"fused_swin_block_plain": 4,
                       "window_attention_plain": 4}]
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b)
