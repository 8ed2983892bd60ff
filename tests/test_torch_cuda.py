"""The port's CUDA kernels against their plain versions, on the card.

These tests import no JAX (the card machine has none) and skip without a
CUDA device.  Run them on the card, where tests/conftest.py (which sets
up JAX) cannot load:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: both sides compute in bf16 and round at different points, so
they differ by a few bf16 ulps of the output scale.  Gradients are held to
5e-2 of each gradient's own largest magnitude: they go through up to six
bf16-rounded products, and the kernels sum weight and bias-plane gradients
with f32 atomics in a different order than the plain version.
"""

import numpy as np
import pytest
import torch

from kvq_tpu_torch.ops import gemm as G
from kvq_tpu_torch.ops import train_attention as TA
from kvq_tpu_torch.ops import window_attention as TWA

GRAD_TOL = 5e-2


def _block_inputs(dims, window, shift, use_frag, C, h, seed=0):
    rng = np.random.default_rng(seed)
    N = window[0] * window[1] * window[2]
    nW = 1
    for d, w in zip(dims, window):
        nW *= d // w
    hidden = 4 * C

    def r(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))

    params = {  # nn.Linear layout (out, in)
        "norm1_scale": 1 + r(C, scale=0.1), "norm1_bias": r(C, scale=0.1),
        "qkv_w": r(3 * C, C, scale=C ** -0.5), "qkv_b": r(3 * C, scale=0.1),
        "proj_w": r(C, C, scale=C ** -0.5), "proj_b": r(C, scale=0.1),
        "norm2_scale": 1 + r(C, scale=0.1), "norm2_bias": r(C, scale=0.1),
        "fc1_w": r(hidden, C, scale=C ** -0.5), "fc1_b": r(hidden, scale=0.1),
        "fc2_w": r(C, hidden, scale=hidden ** -0.5), "fc2_b": r(C, scale=0.1),
    }
    rel = r(h, N, N)
    frag = r(h, N, N) if use_frag else None
    geo = TWA.WindowGeometry(batch=1, dims=dims, window=window, shift=shift,
                             fragments=(1, 7, 7), num_heads=h,
                             head_dim=C // h, use_frag=use_frag)
    return r(nW, N, C), params, rel, frag, geo


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shift,use_frag", [((0, 0, 0), True),
                                            ((2, 3, 3), True),
                                            ((2, 3, 3), False)])
def test_fused_swin_block_kernel_matches_plain(cuda, shift, use_frag):
    _check_fused_swin_block(cuda, (8, 14, 14), (4, 7, 7), shift, use_frag)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [(0, 0, 0), (2, 2, 2)])
def test_fused_swin_block_kernel_matches_plain_n64(cuda, shift):
    """swin_tiny_grpb_m's (4, 4, 4) windows: N=64, no fragment bias."""
    _check_fused_swin_block(cuda, (8, 8, 12), (4, 4, 4), shift, False)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [(0, 0, 0), (0, 3, 3)])
def test_fused_swin_block_kernel_matches_plain_n49(cuda, shift):
    """swin_2d_tiny's (1, 7, 7) windows: N = 49 (odd, no multiple of 8),
    seams in H and W only; stage 0's C = 96 over three heads of 32."""
    _check_fused_swin_block(cuda, (2, 14, 21), (1, 7, 7), shift, False,
                            C=96, h=3)


def _check_fused_swin_block(cuda, dims, window, shift, use_frag, C=64, h=2):
    x, params, rel, frag, geo = _block_inputs(dims, window, shift, use_frag,
                                              C=C, h=h)
    bf = torch.bfloat16
    args = (x.to(cuda, bf), {k: v.to(cuda, bf) for k, v in params.items()},
            rel.to(cuda), None if frag is None else frag.to(cuda), geo)
    before = TWA.fused_swin_block.launches
    out = TWA.fused_swin_block(*args)
    ref = TWA.fused_swin_block_plain(*args)
    torch.cuda.synchronize()
    assert TWA.fused_swin_block.launches == before + 1
    # bf16 on both sides: a few bf16 ulps of the output scale
    scale = max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= 3e-2 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("N,M", [(70, 49), (100, 130)])  # 130: ragged tiles
def test_attention_nobias_kernel_matches_plain(cuda, hd, N, M):
    gen = torch.Generator(device=cuda).manual_seed(0)
    h, C = 3, 3 * hd
    q = torch.randn(5, N, C, generator=gen, device=cuda).bfloat16()
    kv = torch.randn(5, M, 3 * C, generator=gen, device=cuda).bfloat16()
    k, v = kv[..., :C], kv[..., C:2 * C]
    out = TWA.flash_attention_nobias_cl(q, k, v, h, C ** -0.5)
    ref = TWA.attention_nobias_plain(q, k, v, h, C ** -0.5)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    with pytest.raises(TypeError):
        TWA.flash_attention_nobias_cl(q.float(), k, v, h)


def _grad_close(name, got, want):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= GRAD_TOL * max(scale, 1e-6), (name, err, scale)


def _multipliers(BW, seed, device):
    keep = np.random.default_rng(seed).random(BW) < 0.8
    return torch.from_numpy(np.where(keep, 1 / 0.8, 0.0).astype(np.float32)
                            ).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,window,shift,use_frag,C,h", [
    ((8, 14, 14), (4, 7, 7), (0, 0, 0), True, 64, 2),
    ((8, 14, 14), (4, 7, 7), (2, 3, 3), True, 64, 2),
    ((8, 14, 14), (4, 7, 7), (2, 0, 0), False, 64, 2),
    # a stage-0 window shape of the packed-qkv attention backward: the
    # shipped (8, 7, 7) window (N = 392, ragged 64-row tiles), C = 96,
    # three heads, 16 windows
    ((8, 28, 28), (8, 7, 7), (0, 0, 0), True, 96, 3),
    ((8, 28, 28), (8, 7, 7), (4, 3, 3), True, 96, 3),
    # swin_2d_tiny's (1, 7, 7) windows: N = 49, seams in H and W only
    ((2, 14, 21), (1, 7, 7), (0, 0, 0), False, 96, 3),
    ((2, 14, 21), (1, 7, 7), (0, 3, 3), False, 96, 3),
])
def test_train_swin_block_kernels_match_plain(cuda, dims, window, shift,
                                              use_frag, C, h):
    x, params, rel, frag, geo = _block_inputs(dims, window, shift, use_frag,
                                              C=C, h=h)
    bf = torch.bfloat16
    x = x.to(cuda, bf)
    params = {k: v.to(cuda, bf) for k, v in params.items()}
    rel = rel.to(cuda)
    frag = None if frag is None else frag.to(cuda)
    dp1, dp2 = _multipliers(len(x), 1, cuda), _multipliers(len(x), 2, cuda)
    scale = geo.head_dim ** -0.5
    dout = torch.randn(x.shape, generator=torch.Generator(device=cuda)
                       .manual_seed(3), device=cuda).to(bf)
    before = (TA.train_swin_block.launches, TA.train_swin_block_bwd.launches)
    out, kept = TA.train_swin_block_fwd(x, params, rel, frag, geo, scale,
                                        dp1, dp2, keep=True)
    dx, g, drel, dfrag = TA.train_swin_block_bwd(x, params, rel, frag, geo,
                                                 scale, dp1, dp2, kept, dout)
    torch.cuda.synchronize()
    assert (TA.train_swin_block.launches, TA.train_swin_block_bwd.launches) \
        == (before[0] + 1, before[1] + 1)
    ref, rkept = TWA.fused_swin_block_plain(x, params, rel, frag, geo, scale,
                                            dp1, dp2, keep=True)
    rdx, rg, rdrel, rdfrag = TA.train_swin_block_bwd_plain(
        x, params, rel, frag, geo, scale, dp1, dp2, rkept, dout)
    tol = 3e-2 * max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= tol
    _grad_close("dx", dx, rdx)
    _grad_close("drel", drel, rdrel)
    if use_frag:
        _grad_close("dfrag", dfrag, rdfrag)
    for k in g:
        assert g[k].dtype == torch.float32
        _grad_close(k, g[k].reshape(rg[k].shape), rg[k])


def _k4_case(cuda, dims, window, shift, use_frag, C, h):
    """A K4 block on the card: (x, params, rel, frag, geo, dp1, dp2,
    dout), weights, x and the planes as bf16/f32 leaves requiring grad."""
    x, params, rel, frag, geo = _block_inputs(dims, window, shift, use_frag,
                                              C=C, h=h)
    bf = torch.bfloat16
    x = x.to(cuda, bf).requires_grad_()
    params = {k: v.to(cuda, bf).requires_grad_() for k, v in params.items()}
    rel = rel.to(cuda).requires_grad_()
    frag = None if frag is None else frag.to(cuda).requires_grad_()
    dp1, dp2 = _multipliers(len(x), 1, cuda), _multipliers(len(x), 2, cuda)
    dout = torch.randn(x.shape, generator=torch.Generator(device=cuda)
                       .manual_seed(3), device=cuda).to(bf)
    return x, params, rel, frag, geo, dp1, dp2, dout


def _rel_gap(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


# one bf16 rounding, relative: the least gap two orders of f32 atomics can
# leave in a gradient rounded to bf16, when the runs that set the yardstick
# happened to sum in one order
BF16_ROUNDING = 2.0 ** -8


def _agree(name, got, runs):
    """``got`` within 10x the widest gap between ``runs`` of the sequence it
    replaces (or one bf16 rounding, where those runs agree bit for bit) of
    the first run.  Prints both gaps."""
    ee = max(_rel_gap(a, b) for i, a in enumerate(runs) for b in runs[:i])
    gap = _rel_gap(got.to(runs[0].dtype), runs[0])
    print(f"{name}: gap {gap:.3g}, run to run {ee:.3g}")
    assert gap <= max(10 * ee, BF16_ROUNDING), (name, gap, ee)


K4_CASES = [
    ((8, 14, 14), (4, 7, 7), (2, 3, 3), True, 64, 2),
    ((8, 28, 28), (8, 7, 7), (4, 3, 3), True, 96, 3),
    ((2, 14, 21), (1, 7, 7), (0, 3, 3), False, 96, 3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dims,window,shift,use_frag,C,h", K4_CASES)
def test_train_swin_block_backward_from_kept_matches_recompute(
        cuda, dims, window, shift, use_frag, C, h):
    """K4's Function, whose backward reads what its forward kept, against
    the recompute-then-backward sequence it replaced: the block forward
    again (``block_forward_cuda`` keeping its intermediates), then the
    backward from those.  The kept tensors and the output equal the
    recompute's bit for bit (the same arithmetic); dx, the plane and weight
    gradients agree within 10x the gap between three runs of the recompute
    sequence (the weight and plane gradients sum with f32 atomics in no
    fixed order)."""
    x, params, rel, frag, geo, dp1, dp2, dout = _k4_case(
        cuda, dims, window, shift, use_frag, C, h)
    scale = geo.head_dim ** -0.5
    leaves = [x, rel, *params.values()] + ([frag] if use_frag else [])
    y = TA.train_swin_block(x, params, rel, frag, geo, dp1, dp2)
    kept = y.grad_fn.saved_tensors[-len(TA.KEPT):]
    got = torch.autograd.grad(y, leaves, dout)

    def recompute():
        with torch.no_grad():
            out, fw = TWA.block_forward_cuda(x, params, rel, frag, geo,
                                             scale, dp1, dp2, keep=True)
            dx, g, drel, dfrag = TA.train_swin_block_bwd(
                x, params, rel, frag, geo, scale, dp1, dp2, fw, dout)
        grads = [dx, drel, *(g[k].reshape(params[k].shape)
                             .to(params[k].dtype) for k in params)]
        return out, fw, grads + ([dfrag] if use_frag else [])

    runs = [recompute() for _ in range(3)]
    torch.cuda.synchronize()
    out, fw, _ = runs[0]
    assert torch.equal(y.detach(), out)
    for name, t in zip(TA.KEPT, kept):
        assert torch.equal(t, fw[name]), name
    names = ["dx", "drel", *params] + (["dfrag"] if use_frag else [])
    for i, name in enumerate(names):
        _agree(name, got[i], [r[2][i] for r in runs])


@pytest.mark.cuda
@pytest.mark.parametrize("dims,window,shift,use_frag,C,h", K4_CASES[:2])
def test_train_swin_block_kept_bytes_on_the_card(cuda, dims, window, shift,
                                                 use_frag, C, h):
    """``kept_bytes`` on the ``kvq.k4.fwd`` span is the bytes of what the
    Function saved beyond its inputs: the eight intermediates of ``KEPT``,
    the row log-sum-exp among them."""
    from kvq_tpu_torch.core import tracing

    x, params, rel, frag, geo, dp1, dp2, _ = _k4_case(
        cuda, dims, window, shift, use_frag, C, h)
    with tracing.recording():
        since = tracing.mark()
        y = TA.train_swin_block(x, params, rel, frag, geo, dp1, dp2)
        spans = [s for s in tracing.spans(since) if s["name"] == "kvq.k4.fwd"]
    inputs = {t.data_ptr() for t in (x, rel, frag, dp1, dp2,
                                     *params.values()) if t is not None}
    saved = [t for t in y.grad_fn.saved_tensors
             if t is not None and t.data_ptr() not in inputs]
    assert len(saved) == len(TA.KEPT)
    assert spans[-1]["attrs"]["kept_bytes"] == sum(
        t.numel() * t.element_size() for t in saved)


@pytest.mark.cuda
@pytest.mark.parametrize("use_frag", [True, False])
def test_checkpointed_k4_block_matches_unchecked(cuda, use_frag):
    """A SwinBlock3D stage under ``use_checkpoint=True`` (non-reentrant
    ``torch.utils.checkpoint``, which drops what K4 kept and recomputes it)
    gives the gradients of the same stage without: within 10x the gap of
    three unchecked runs.  Each block's forward runs once a step without
    remat and twice with it."""
    from kvq_tpu_torch.nn.swin import BasicLayer

    torch.manual_seed(0)
    layers = [BasicLayer(64, 2, 2, (4, 7, 7), frag_bias=use_frag,
                         use_pallas=True, downsample=False,
                         use_checkpoint=ck).to(cuda, torch.bfloat16).train()
              for ck in (False, True)]
    layers[1].load_state_dict(layers[0].state_dict())
    x = torch.randn(2, 8, 14, 14, 64, generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda).to(torch.bfloat16)
    dy = torch.randn_like(x)
    runs, forwards = [], []
    for layer in (layers[1], *[layers[0]] * 3):
        xi = x.clone().requires_grad_()
        before = (TA.train_swin_block.launches,
                  TA.train_swin_block_bwd.launches)
        layer(xi, gen=torch.Generator(device=cuda).manual_seed(2)).backward(
            dy)
        forwards.append((TA.train_swin_block.launches - before[0],
                         TA.train_swin_block_bwd.launches - before[1]))
        runs.append([xi.grad] + [p.grad for p in layer.parameters()])
        layer.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    assert forwards == [(4, 2)] + [(2, 2)] * 3
    names = ["dx"] + [n for n, _ in layers[0].named_parameters()]
    for i, name in enumerate(names):
        _agree(name, runs[0][i], [r[i] for r in runs[1:]])


def _window_scores_plain(q, k, rel, frag, geo, scale):
    """The plain window scores (BW, h, N, N) in f32: q scaled and rounded as
    the kernels do, the gate-blended bias and the seam mask."""
    gate, mask = TWA.gate_and_mask(geo, q.device)
    nW = geo.n_windows
    s = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    s = s.reshape(-1, nW, *s.shape[1:])
    if frag is None:
        s = s + rel[None, None]
    else:
        g = gate[None, :, None]
        s = s + rel[None, None] * g + frag[None, None] * (1.0 - g)
    if mask is not None:
        s = s + mask[None, :, None]
    return s.reshape(q.shape[0], *s.shape[2:])


@pytest.mark.cuda
@pytest.mark.parametrize("dims,window,shift,use_frag,batch", [
    ((8, 14, 14), (4, 7, 7), (0, 0, 0), True, 2),
    ((8, 14, 14), (4, 7, 7), (2, 3, 3), True, 2),
    ((8, 14, 14), (4, 7, 7), (2, 0, 0), False, 2),
    ((8, 14, 14), (8, 7, 7), (0, 0, 0), True, 2),   # N = 392: ragged tiles
    ((8, 14, 14), (8, 7, 7), (4, 3, 3), True, 2),
    ((8, 14, 14), (8, 7, 7), (4, 3, 3), False, 2),
    # 13 windows: the bias pass's chunks of 2 do not divide them, and the
    # last CTA of the DQ and DK/DV passes has an empty window slot
    ((8, 7, 7), (8, 7, 7), (0, 0, 0), True, 13),
    ((4, 10, 15), (4, 5, 5), (2, 2, 2), True, 2),   # N = 100
    ((4, 10, 15), (4, 5, 5), (0, 0, 0), False, 2),
    ((2, 5, 10), (2, 5, 5), (0, 0, 0), True, 3),    # N = 50
    ((2, 10, 5), (2, 5, 5), (1, 2, 2), False, 3),
])
def test_window_attention_train_kernels_match_plain(cuda, dims, window, shift,
                                                    use_frag, batch):
    _check_window_attention_train(cuda, dims, window, shift, use_frag, batch,
                                  h=3)


@pytest.mark.cuda
def test_window_attention_train_kernels_match_plain_padded_stage1(cuda):
    """K5 at swin_tiny_grpb's training geometry of stage 1 on the KVQ
    technical view (B=4, 16x36x36 tokens padded to 16x42x42, 6 heads),
    shifted and fragment-biased: 288 windows of the seam mask and the gated
    bias whose plane gradients the bias pass sums."""
    _check_window_attention_train(cuda, (16, 42, 42), (8, 7, 7), (4, 3, 3),
                                  True, 4, h=6)


def _check_window_attention_train(cuda, dims, window, shift, use_frag,
                                  batch, h):
    hd = 32
    geo = TWA.WindowGeometry(batch=batch, dims=dims, window=window,
                             shift=shift, fragments=(1, 7, 7), num_heads=h,
                             head_dim=hd, use_frag=use_frag)
    gen = torch.Generator(device=cuda).manual_seed(0)
    N, BW = geo.n_tokens, geo.batch * geo.n_windows

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=cuda)

    q, k, v = (rnd(BW, h, N, hd).bfloat16() for _ in range(3))
    rel = rnd(h, N, N)
    frag = rnd(h, N, N) if use_frag else None
    dout = rnd(BW, h, N, hd).bfloat16()
    scale = hd ** -0.5
    out, lse = TA.window_attention_train_fwd(q, k, v, rel, frag, geo, scale)
    before = TA.window_attention_train_bwd.launches
    grads = TA.window_attention_train_bwd(q, k, v, rel, frag, geo, scale,
                                          out, lse, dout)
    torch.cuda.synchronize()
    assert TA.window_attention_train_bwd.launches == before + 1
    assert (grads[4] is None) == (not use_frag)
    # the row log-sum-exp the backward reads: f32 scores on both sides, only
    # the products' summation order and the kernel's exp2 differ
    want_lse = _window_scores_plain(q, k, rel, frag, geo, scale).logsumexp(-1)
    assert lse.shape == (BW, h, N) and lse.dtype == torch.float32
    assert (lse - want_lse).abs().max().item() <= 1e-3
    ref = TA.window_attention_train_plain(q, k, v, rel, frag, geo, scale)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2 * max(
        1.0, ref.float().abs().max().item())
    want = TA.window_attention_train_bwd_plain(q, k, v, rel, frag, geo,
                                               scale, out, dout)
    for name, a, b in zip(("dq", "dk", "dv", "drel", "dfrag"), grads, want):
        if b is not None:
            assert a.shape == b.shape, name
            _grad_close(name, a, b)
    # through autograd: the module path's call
    qg = q.clone().requires_grad_()
    y = TA.window_attention_train(qg, k, v, rel, frag, geo)
    y.backward(dout)
    _grad_close("autograd dq", qg.grad, want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dims,window,shift,use_frag,hd", [
    ((4, 21, 21), (2, 7, 7), (1, 3, 3), True, 32),   # padded, shifted, frag
    ((8, 14, 14), (8, 7, 7), (4, 3, 3), True, 32),   # N = 392: ragged tail
    ((8, 12, 12), (4, 4, 4), (2, 2, 2), False, 64),  # N = 64
    ((4, 5, 5), (4, 5, 5), (0, 0, 0), True, 32),     # clamped, N = 100
    ((2, 5, 5), (2, 5, 5), (0, 0, 0), False, 32),    # clamped, N = 50
    # window counts that leave the card's last wave of CTAs part-filled
    ((8, 7, 21), (8, 7, 7), (4, 3, 3), True, 32),    # 6 windows
    ((8, 91, 77), (8, 7, 7), (4, 3, 3), True, 32),   # 286 windows
    ((8, 91, 77), (8, 7, 7), (4, 3, 3), False, 32),
])
def test_window_attention_packed_kernel_matches_plain(cuda, dims, window,
                                                      shift, use_frag, hd):
    h = 3
    geo = TWA.WindowGeometry(batch=2, dims=dims, window=window, shift=shift,
                             fragments=(1, 7, 7), num_heads=h, head_dim=hd,
                             use_frag=use_frag)
    gen = torch.Generator(device=cuda).manual_seed(1)
    N, BW = geo.n_tokens, geo.batch * geo.n_windows
    qkv = torch.randn(BW, N, 3 * h * hd, generator=gen, device=cuda).bfloat16()
    rel = torch.randn(h, N, N, generator=gen, device=cuda)
    frag = torch.randn(h, N, N, generator=gen, device=cuda) if use_frag \
        else None
    before = TWA.flash_window_attention_packed.launches
    out = TWA.flash_window_attention_packed(qkv, rel, frag, geo)
    ref = TWA.flash_window_attention_packed_plain(qkv, rel, frag, geo,
                                                  hd ** -0.5)
    torch.cuda.synchronize()
    assert TWA.flash_window_attention_packed.launches == before + 1
    assert out.shape == (BW, N, h * hd) and out.dtype == torch.bfloat16
    scale = max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2 * scale
    with pytest.raises(TypeError):
        TWA.flash_window_attention_packed(qkv.float(), rel, frag, geo)


@pytest.mark.cuda
@pytest.mark.parametrize("shift,use_frag", [((0, 0, 0), True),
                                            ((2, 3, 3), False)])
def test_window_attention_heads_kernel_matches_plain(cuda, shift, use_frag):
    h, hd = 3, 32
    geo = TWA.WindowGeometry(batch=2, dims=(8, 21, 21), window=(4, 7, 7),
                             shift=shift, fragments=(1, 7, 7), num_heads=h,
                             head_dim=hd, use_frag=use_frag)
    gen = torch.Generator(device=cuda).manual_seed(2)
    N, BW = geo.n_tokens, geo.batch * geo.n_windows
    # q, k and v as strided column blocks of one tensor: row stride 3 * hd
    t = torch.randn(BW, h, N, 3 * hd, generator=gen, device=cuda).bfloat16()
    q, k, v = t.split(hd, dim=-1)
    rel = torch.randn(h, N, N, generator=gen, device=cuda)
    frag = torch.randn(h, N, N, generator=gen, device=cuda) if use_frag \
        else None
    before = TWA.flash_window_attention.launches
    out = TWA.flash_window_attention(q, k, v, rel, frag, geo)
    ref = TWA.flash_window_attention_plain(q, k, v, rel, frag, geo,
                                           hd ** -0.5)
    torch.cuda.synchronize()
    assert TWA.flash_window_attention.launches == before + 1
    scale = max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("N,M", [(70, 49), (100, 130)])  # 130: ragged tiles
def test_attention_nobias_heads_kernel_matches_plain(cuda, hd, N, M):
    gen = torch.Generator(device=cuda).manual_seed(3)
    X, h = 5, 3
    q = torch.randn(X, h, N, hd, generator=gen, device=cuda).bfloat16()
    # k and v read through the strides of a (X, M, h, 2 hd) projection
    kv = torch.randn(X, M, h, 2 * hd, generator=gen, device=cuda).bfloat16()
    k, v = kv.permute(0, 2, 1, 3).split(hd, dim=-1)
    before = TWA.flash_attention_nobias.launches
    out = TWA.flash_attention_nobias(q, k, v, 0.1)
    ref = TWA.attention_nobias_heads_plain(q, k, v, 0.1)
    torch.cuda.synchronize()
    assert TWA.flash_attention_nobias.launches == before + 1
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    with pytest.raises(ValueError):  # rows that are not contiguous
        TWA.flash_attention_nobias(
            q.transpose(2, 3).contiguous().transpose(2, 3), k, v)



# The block's products: ragged M (2352 + 37 rows: 19 row tiles, the last one
# 85 rows short), N and K at the shipped widths, every layout and epilogue
# with the plan's tile width, and every tile width at one shape.
_GEMM_CASES = ("fwd_bias", "fwd_gelu_pre", "fwd_droppath_res", "dx_f32",
               "dx_bf16", "dx_gelu", "dw")
_GEMM_PARAMS = (
    [(c, n, k, None) for c in _GEMM_CASES for n in (96, 288, 384, 768, 2304)
     for k in (96, 384, 3072)]
    + [(c, 384, 384, bn) for c in ("fwd_droppath_res", "dx_gelu", "dw")
       for bn in G.WIDTHS])


@pytest.mark.cuda
@pytest.mark.parametrize("case,N,K,bn", _GEMM_PARAMS)
def test_gemm_kernel_matches_f32_matmul(cuda, case, N, K, bn):
    """Each layout and epilogue against its plain version: an f32
    torch.matmul (full f32: TF32 is off) of the same bf16 inputs with the
    epilogue in f32, rounded where the kernel rounds.  Both sum exact
    products in f32 in different orders, so a bf16 output may round the
    other way: up to one bf16 ulp per rounding (three in the residual
    epilogue), held to 2e-2 of the output scale; f32 outputs (dX f32 and
    dW's split-K atomics over the 2,389 rows) to 1e-3 of it."""
    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(N * 7 + K)
    M = 2352 + 37
    bf = torch.bfloat16

    def r(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.normal(size=shape) * scale).astype(np.float32)).to(cuda, bf)

    if case.startswith("fwd"):
        a, w, bias = r(M, K), r(N, K, scale=K ** -0.5), r(N, scale=0.1)
        kw = {}
        if case == "fwd_gelu_pre":
            kw = dict(gelu=True, keep_pre=True)
        if case == "fwd_droppath_res":
            rows = 49
            kw = dict(res=r(M, N), dp_rows=rows,
                      dp=_multipliers(-(-M // rows), 4, cuda))
        out, pre = G.linear(a, w, bias, bn=bn, **kw)
        kw.pop("keep_pre", None)
        want, want_pre = G.linear_plain(a, w, bias, **kw)
        got = [(out, want)] + ([(pre, want_pre)] if pre is not None else [])
        tol = 2e-2
    elif case.startswith("dx"):
        epi = {"dx_f32": G.EPI_F32, "dx_bf16": G.EPI_BF16,
               "dx_gelu": G.EPI_GELU_BWD}[case]
        dy, w = r(M, K), r(K, N, scale=K ** -0.5)
        aux = r(M, N) if epi == G.EPI_GELU_BWD else None
        out = G.input_grad(dy, w, epi, aux, bn=bn)
        got = [(out, G.input_grad_plain(dy, w, epi, aux))]
        assert out.dtype == (torch.float32 if epi == G.EPI_F32 else bf)
        tol = 1e-3 if epi == G.EPI_F32 else 2e-2
    else:
        dy, x = r(M, N), r(M, K)
        out = G.weight_grad(dy, x, bn=bn)
        got = [(out, G.weight_grad_plain(dy, x))]
        assert out.dtype == torch.float32
        tol = 1e-3
    torch.cuda.synchronize()
    for out, want in got:
        assert out.shape == want.shape
        scale = max(1.0, want.float().abs().max().item())
        err = (out.float() - want.float()).abs().max().item()
        assert err <= tol * scale, (case, N, K, bn, err, scale)
