"""The port's CUDA kernels against their plain versions, on the card.

These tests import no JAX (the card machine has none) and skip without a
CUDA device.  Run them on the card, where tests/conftest.py (which sets
up JAX) cannot load:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: both sides compute in bf16 and round at different points, so
they differ by a few bf16 ulps of the output scale.
"""

import numpy as np
import pytest
import torch

from kvq_tpu_torch.ops import window_attention as TWA


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
    dims, window = (8, 14, 14), (4, 7, 7)
    x, params, rel, frag, geo = _block_inputs(dims, window, shift, use_frag,
                                              C=64, h=2)
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
def test_attention_nobias_kernel_matches_plain(cuda, hd):
    gen = torch.Generator(device=cuda).manual_seed(0)
    h, C = 3, 3 * hd
    q = torch.randn(5, 70, C, generator=gen, device=cuda).bfloat16()
    kv = torch.randn(5, 49, 3 * C, generator=gen, device=cuda).bfloat16()
    k, v = kv[..., :C], kv[..., C:2 * C]
    out = TWA.flash_attention_nobias_cl(q, k, v, h, C ** -0.5)
    ref = TWA.attention_nobias_plain(q, k, v, h, C ** -0.5)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    with pytest.raises(TypeError):
        TWA.flash_attention_nobias_cl(q.float(), k, v, h)
