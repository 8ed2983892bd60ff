"""The port's K1 (fused Swin block) and K2 (no-bias CDM attention) against
the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain versions; the JAX kernels run
in Pallas interpret mode.  Tolerance: atol 2e-4, rtol 1e-3 in float32, the
JAX suite's own kernel-vs-XLA bound (tests/test_window_attention.py) — the
TPU kernels fold the softmax and use a polynomial erf, the port computes the
XLA composition.  The CUDA kernels themselves are held against the plain
versions on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import kvq_tpu.ops.window_attention as WA
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
