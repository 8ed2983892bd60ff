"""The port's K1 (fused Swin block), K2 (no-bias CDM attention), K4 (train
block) and K5 (train window attention) against the JAX package.

On the CPU the port's wrappers run their plain versions; the JAX kernels run
in Pallas interpret mode.  Tolerance: atol 2e-4, rtol 1e-3 in float32, the
JAX suite's own kernel-vs-XLA bound (tests/test_window_attention.py) — the
TPU kernels fold the softmax and use a polynomial erf, the port computes the
XLA composition.  The CUDA kernels themselves are held against the plain
versions on the card by tests/test_torch_cuda.py.

K5's plain forward and backward are held against the JAX package's
``window_attention_train`` in interpret mode (``TRAIN_INTERPRET``), K4's
against ``jax.grad`` of the reference's XLA block composition with the same
explicit DropPath multipliers (interpret-mode K4 is what keeps
tests/test_train_block.py out of tier 1).  Both plain backwards are also
held against torch autograd through their plain forwards.  Tolerances in
float32: the kernel bound above for outputs; gradients atol 1e-4 x the
gradient's own scale (f32 sums over up to 392 keys and 16 windows, taken
in another order), rtol 1e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import kvq_tpu.ops.window_attention as WA
from kvq_tpu_torch.ops import train_attention as TTA
from kvq_tpu_torch.ops import window_attention as TWA

ATOL, RTOL = 2e-4, 1e-3


def _block_inputs(dims, window, shift, use_frag, C=16, h=2, B=1, seed=0):
    rng = np.random.default_rng(seed)
    N = window[0] * window[1] * window[2]
    nW = 1
    for d, w in zip(dims, window):
        nW *= d // w
    hidden = 4 * C

    def r(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    jp = {  # JAX kernel layout: Dense kernels (in, out)
        "norm1_scale": 1 + r(C, scale=0.1), "norm1_bias": r(C, scale=0.1),
        "qkv_w": r(C, 3 * C, scale=0.3), "qkv_b": r(3 * C, scale=0.1),
        "proj_w": r(C, C, scale=0.3), "proj_b": r(C, scale=0.1),
        "norm2_scale": 1 + r(C, scale=0.1), "norm2_bias": r(C, scale=0.1),
        "fc1_w": r(C, hidden, scale=0.3), "fc1_b": r(hidden, scale=0.1),
        "fc2_w": r(hidden, C, scale=0.2), "fc2_b": r(C, scale=0.1),
    }
    rel = r(h, N, N)
    frag = r(h, N, N) if use_frag else None
    x = r(B * nW, N, C)
    geo_kw = dict(batch=B, dims=dims, window=window, shift=shift,
                  fragments=(1, 7, 7), num_heads=h, head_dim=C // h,
                  use_frag=use_frag)
    return jp, rel, frag, x, geo_kw


def _torch_params(jp):
    return {k: torch.from_numpy(v.T.copy() if k.endswith("_w") else v)
            for k, v in jp.items()}


def _jax_block(jp, rel, frag, x, geo_kw):
    geo = WA.WindowGeometry(**geo_kw)
    return np.asarray(WA.fused_swin_block(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in jp.items()},
        jnp.asarray(rel), None if frag is None else jnp.asarray(frag), geo,
        interpret=True,
    ))


@pytest.mark.parametrize(
    "dims,window,shift,use_frag",
    [
        ((4, 14, 14), (2, 7, 7), (0, 0, 0), True),    # unshifted, frag
        ((4, 14, 14), (2, 7, 7), (1, 3, 3), True),    # shifted: h/w + last-d seam
        ((4, 14, 14), (2, 7, 7), (1, 3, 3), False),   # shifted, no frag
        ((4, 7, 7), (2, 7, 7), (1, 0, 0), False),     # d seam only (stage-3 form)
        ((2, 14, 14), (2, 7, 7), (0, 3, 3), True),    # one d window, h/w seam
    ],
)
def test_fused_swin_block_plain_matches_jax_kernel(dims, window, shift,
                                                   use_frag):
    jp, rel, frag, x, geo_kw = _block_inputs(dims, window, shift, use_frag)
    ref = _jax_block(jp, rel, frag, x, geo_kw)
    before = TWA.fused_swin_block.launches
    out = TWA.fused_swin_block(
        torch.from_numpy(x), _torch_params(jp), torch.from_numpy(rel),
        None if frag is None else torch.from_numpy(frag),
        TWA.WindowGeometry(**geo_kw),
    )
    # CPU tensors take the plain version: no kernel launch is counted
    assert TWA.fused_swin_block.launches == before
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize(
    "X,N,M,C,h,scale",
    [
        (4, 24, 10, 32, 2, 32 ** -0.5),   # cross attention: scale 1/sqrt(C)
        (3, 16, 16, 64, 4, 16 ** -0.5),   # temporal: scale 1/sqrt(hd)
        (2, 40, 49, 48, 3, 48 ** -0.5),   # M not a multiple of 8
    ],
)
def test_attention_nobias_plain_matches_jax_kernel(X, N, M, C, h, scale):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(X, N, C)).astype(np.float32)
    kv = rng.normal(size=(X, M, 2 * C)).astype(np.float32)
    ref = np.asarray(WA.flash_attention_nobias_cl(
        jnp.asarray(q), jnp.asarray(kv[..., :C]), jnp.asarray(kv[..., C:]),
        num_heads=h, scale=scale, interpret=True,
    ))
    tkv = torch.from_numpy(kv)
    out = TWA.flash_attention_nobias_cl(
        torch.from_numpy(q), tkv[..., :C], tkv[..., C:], h, scale)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_gate_and_mask_match_jax_geometry():
    from kvq_tpu.nn import swin as S

    for dims, window, shift in [((4, 14, 14), (2, 7, 7), (1, 3, 3)),
                                ((8, 28, 28), (2, 7, 7), (0, 0, 0)),
                                ((4, 14, 14), (2, 7, 7), (0, 3, 3))]:
        geo = TWA.WindowGeometry(batch=1, dims=dims, window=window,
                                 shift=shift, fragments=(1, 7, 7),
                                 num_heads=1, head_dim=8, use_frag=True)
        gate, mask = TWA.gate_and_mask(geo, "cpu")
        np.testing.assert_array_equal(
            gate.numpy(), S.fragment_gate(dims, (1, 7, 7), window, shift))
        ref = S.compute_shift_mask(dims, window, shift)
        if ref is None:
            assert mask is None
        else:
            np.testing.assert_array_equal(mask.numpy(), ref)


def test_wrappers_reject_bad_shapes():
    jp, rel, frag, x, geo_kw = _block_inputs((4, 14, 14), (2, 7, 7),
                                             (0, 0, 0), True)
    geo = TWA.WindowGeometry(**geo_kw)
    with pytest.raises(ValueError):
        TWA.fused_swin_block(torch.from_numpy(x[:-1]), _torch_params(jp),
                             torch.from_numpy(rel), torch.from_numpy(frag),
                             geo)
    with pytest.raises(ValueError):  # frag planes without use_frag
        TWA.fused_swin_block(
            torch.from_numpy(x), _torch_params(jp), torch.from_numpy(rel),
            torch.from_numpy(frag),
            TWA.WindowGeometry(**{**geo_kw, "use_frag": False}))
    q = torch.zeros(2, 8, 30)
    with pytest.raises(ValueError):
        TWA.flash_attention_nobias_cl(q, q, q, 4)


def _grad_close(got, want, name=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=1e-3,
                               err_msg=name)


TRAIN_GEOMETRIES = [
    ((4, 14, 14), (1, 3, 3), True),    # h/w + last-d seam, fragment bias
    ((4, 14, 14), (0, 0, 0), True),
    ((4, 14, 14), (1, 3, 3), False),
    ((4, 7, 7), (1, 0, 0), False),     # d seam only (stage-3 form)
]


def _attention_inputs(dims, shift, use_frag, h=2, hd=8, seed=4):
    rng = np.random.default_rng(seed)
    geo_kw = dict(batch=1, dims=dims, window=(2, 7, 7), shift=shift,
                  fragments=(1, 7, 7), num_heads=h, head_dim=hd,
                  use_frag=use_frag)
    geo = TWA.WindowGeometry(**geo_kw)
    BW, N = geo.n_windows, geo.n_tokens
    q, k, v, dout = (rng.normal(size=(BW, h, N, hd)).astype(np.float32)
                     for _ in range(4))
    rel = rng.normal(size=(h, N, N), scale=0.5).astype(np.float32)
    frag = (rng.normal(size=(h, N, N), scale=0.5).astype(np.float32)
            if use_frag else None)
    return geo_kw, geo, q, k, v, rel, frag, dout


@pytest.mark.parametrize("dims,shift,use_frag", TRAIN_GEOMETRIES)
def test_window_attention_train_plain_matches_jax_kernel(dims, shift,
                                                         use_frag):
    geo_kw, geo, q, k, v, rel, frag, dout = _attention_inputs(dims, shift,
                                                              use_frag)
    jgeo = WA.WindowGeometry(**geo_kw)
    args = [jnp.asarray(a) for a in (q, k, v, rel)]
    if use_frag:
        args.append(jnp.asarray(frag))

    def f(*a):
        return WA.window_attention_train(*a[:4], a[4] if use_frag else None,
                                         jgeo)

    old = WA.TRAIN_INTERPRET
    WA.TRAIN_INTERPRET = True
    try:
        ref, vjp = jax.vjp(f, *args)
        ref_grads = vjp(jnp.asarray(dout))
    finally:
        WA.TRAIN_INTERPRET = old
    t = [torch.from_numpy(a) for a in (q, k, v, rel)]
    tfrag = torch.from_numpy(frag) if use_frag else None
    out, lse = TTA.window_attention_train_fwd(*t, tfrag, geo, 8 ** -0.5)
    assert lse is None  # the CPU takes the plain version
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    grads = TTA.window_attention_train_bwd(*t, tfrag, geo, 8 ** -0.5, out,
                                           None, torch.from_numpy(dout))
    for name, got, want in zip(("dq", "dk", "dv", "drel", "dfrag"), grads,
                               ref_grads):
        _grad_close(got, want, name)


def _golden_jax(jp, x, rel, frag, dp1, dp2, geo_kw, dout):
    """jax.grad of the reference's XLA block composition (the golden of
    tests/test_train_block.py) with explicit DropPath multipliers."""
    from kvq_tpu.nn import swin as S
    from test_train_block import _golden_block

    dims, window, shift = geo_kw["dims"], geo_kw["window"], geo_kw["shift"]
    gate = (jnp.asarray(S.fragment_gate(dims, (1, 7, 7), window, shift))
            if frag is not None else None)
    m = S.compute_shift_mask(dims, window, shift)
    mask = None if m is None else jnp.asarray(m)
    h = geo_kw["num_heads"]

    def f(x, params, rel, frag):
        return _golden_block(x, params, rel, frag, gate, mask,
                             jnp.asarray(dp1)[:, None],
                             jnp.asarray(dp2)[:, None], h,
                             geo_kw["head_dim"] ** -0.5)

    jf = None if frag is None else jnp.asarray(frag)
    out, vjp = jax.vjp(f, jnp.asarray(x),
                       {k: jnp.asarray(a) for k, a in jp.items()},
                       jnp.asarray(rel), jf)
    return out, vjp(jnp.asarray(dout))


@pytest.mark.parametrize("dims,window,shift,use_frag", [
    ((4, 14, 14), (2, 7, 7), (1, 3, 3), True),
    ((4, 14, 14), (2, 7, 7), (0, 0, 0), False),
])
def test_train_swin_block_plain_matches_jax_grad(dims, window, shift,
                                                 use_frag):
    jp, rel, frag, x, geo_kw = _block_inputs(dims, window, shift, use_frag)
    BW = x.shape[0]
    dp1 = np.where(np.arange(BW) % 3 == 1, 0.0, 1 / 0.8).astype(np.float32)
    dp2 = np.where(np.arange(BW) % 4 == 2, 0.0, 1 / 0.8).astype(np.float32)
    dout = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)
    ref, (rdx, rdp, rdrel, rdfrag) = _golden_jax(jp, x, rel, frag, dp1, dp2,
                                                 geo_kw, dout)
    geo = TWA.WindowGeometry(**geo_kw)
    params = _torch_params(jp)
    t = dict(rel_bias=torch.from_numpy(rel),
             frag_bias=None if frag is None else torch.from_numpy(frag))
    out, kept = TTA.train_swin_block_fwd(
        torch.from_numpy(x), params, **t, geo=geo, scale=geo.head_dim ** -0.5,
        dp1=torch.from_numpy(dp1), dp2=torch.from_numpy(dp2), keep=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    dx, g, drel, dfrag = TTA.train_swin_block_bwd(
        torch.from_numpy(x), params, **t, geo=geo, scale=geo.head_dim ** -0.5,
        dp1=torch.from_numpy(dp1), dp2=torch.from_numpy(dp2), kept=kept,
        dout=torch.from_numpy(dout))
    _grad_close(dx, rdx, "dx")
    _grad_close(drel, rdrel, "drel")
    if use_frag:
        _grad_close(dfrag, rdfrag, "dfrag")
    for key, want in rdp.items():  # JAX Dense kernels are (in, out)
        want = np.asarray(want)
        _grad_close(g[key].reshape(want.T.shape if key.endswith("_w")
                                   else want.shape).T
                    if key.endswith("_w") else g[key], want, key)


@pytest.mark.parametrize("dims,shift,use_frag", TRAIN_GEOMETRIES[:1]
                         + TRAIN_GEOMETRIES[3:])
def test_train_plain_backwards_match_autograd(dims, shift, use_frag):
    """The explicit backward formulas against torch autograd through the
    plain forwards (float32: only summation order differs)."""
    geo_kw, geo, q, k, v, rel, frag, dout = _attention_inputs(
        dims, shift, use_frag, hd=8)
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (q, k, v, rel) + ((frag,) if use_frag else ())]
    tfrag = leaves[4] if use_frag else None
    out = TTA.window_attention_train_plain(*leaves[:4], tfrag, geo, 0.3)
    want = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    got = TTA.window_attention_train_bwd_plain(
        *(t.detach() for t in leaves[:4]),
        None if tfrag is None else tfrag.detach(), geo, 0.3, out.detach(),
        torch.from_numpy(dout))
    for a, b in zip(got, want):
        _grad_close(a, b.numpy())
    jp, rel, frag, x, bkw = _block_inputs(dims, (2, 7, 7), shift, use_frag)
    bgeo = TWA.WindowGeometry(**bkw)
    params = {k: v.requires_grad_() for k, v in _torch_params(jp).items()}
    xt = torch.from_numpy(x).requires_grad_()
    relt = torch.from_numpy(rel).requires_grad_()
    fragt = None if frag is None else torch.from_numpy(frag).requires_grad_()
    dp = torch.full((x.shape[0],), 1.25)
    y = TTA.train_swin_block(xt, params, relt, fragt, bgeo, dp, dp * 0.8)
    leaves = [xt, relt, *params.values()] + ([fragt] if use_frag else [])
    dy = torch.from_numpy(np.random.default_rng(2).normal(size=x.shape)
                          .astype(np.float32))
    got = torch.autograd.grad(y, leaves, dy)
    ref = TWA.fused_swin_block_plain(xt, params, relt, fragt, bgeo, None,
                                     dp, dp * 0.8)
    want = torch.autograd.grad(ref, leaves, dy)
    for a, b in zip(got, want):
        _grad_close(a, b.numpy())


def test_window_attention_train_bwd_plain_matches_jax_kernel_n392():
    """The plain backward (the card tests' oracle) at the shipped (8, 7, 7)
    window, N = 392, whose 64-row tiles are ragged: shifted along d, with a
    fragment bias, one head of 32."""
    geo_kw = dict(batch=1, dims=(16, 7, 7), window=(8, 7, 7),
                  shift=(4, 0, 0), fragments=(1, 7, 7), num_heads=1,
                  head_dim=32, use_frag=True)
    geo = TWA.WindowGeometry(**geo_kw)
    BW, N = geo.n_windows, geo.n_tokens
    assert (BW, N) == (2, 392)
    rng = np.random.default_rng(6)
    q, k, v, dout = (rng.normal(size=(BW, 1, N, 32)).astype(np.float32)
                     for _ in range(4))
    rel, frag = (rng.normal(size=(1, N, N), scale=0.5).astype(np.float32)
                 for _ in range(2))
    jgeo = WA.WindowGeometry(**geo_kw)
    old = WA.TRAIN_INTERPRET
    WA.TRAIN_INTERPRET = True
    try:
        ref, vjp = jax.vjp(
            lambda *a: WA.window_attention_train(*a, jgeo),
            *(jnp.asarray(a) for a in (q, k, v, rel, frag)))
        ref_grads = vjp(jnp.asarray(dout))
    finally:
        WA.TRAIN_INTERPRET = old
    t = [torch.from_numpy(a) for a in (q, k, v, rel, frag)]
    out = TTA.window_attention_train_plain(*t, geo, 32 ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    grads = TTA.window_attention_train_bwd_plain(*t, geo, 32 ** -0.5, out,
                                                 torch.from_numpy(dout))
    for name, got, want in zip(("dq", "dk", "dv", "drel", "dfrag"), grads,
                               ref_grads):
        _grad_close(got, want, name)
