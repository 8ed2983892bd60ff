"""The port's Swin-block products (``kvq_tpu_torch/ops/gemm.py``) on the CPU:
the host-side tile plan, the wrappers' refusals, and the plain versions
against the JAX block kernels' products.

The products of the JAX block kernels are ``jax.lax.dot_general`` calls with
float32 accumulation on bf16 operands, the bias added in float32 and the
result rounded to bf16 (``kvq_tpu/ops/window_attention.py``, the block
kernel and its backward).  The port's plain versions take the same inputs;
both sum exact bf16 products in float32, in different orders, so a bf16
output may round the other way: held to 1e-2 of the output scale (a few
bf16 ulps), float32 outputs to 1e-5 of it.  The CUDA kernel itself is held
against the plain versions on the card (tests/test_torch_cuda.py).
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kvq_tpu_torch.ops import gemm as G

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  the shipped product shapes

BF16 = torch.bfloat16


def _products(config):
    """(layout, M, N, K) of every product the K1/K4 paths run for one
    configuration: chip_smoke's KSVQE eval and train cases, and
    swin_tiny_grpb_m's K1 stages 0-1 ((4, 4, 4) windows divide them)."""
    if config == "swin_tiny_grpb_m":
        out = []
        for dims, C, _, _ in chip_smoke.GRPB_M_STAGES[:2]:
            M = math.prod(dims)
            out += [("forward", M, 3 * C, C), ("forward", M, C, C),
                    ("forward", M, 4 * C, C), ("forward", M, C, 4 * C)]
        return out
    kernels = {"KSVQE eval": ("K1",), "KSVQE train": ("K4 fwd", "K4 bwd")}
    return [(layout, M, N, K) for kernel, _, _, layout, M, N, K, _, _
            in chip_smoke.gemm_cases() if kernel in kernels[config]]


@pytest.mark.parametrize("config", ["KSVQE eval", "KSVQE train",
                                    "swin_tiny_grpb_m"])
def test_plan_covers_every_product(config):
    sms = 132  # the H100's SMs
    products = _products(config)
    assert products
    for layout, M, N, K in products:
        plan = G.plan_gemm(layout, M, N, K, sms)
        what = (layout, M, N, K, plan)
        assert plan.bn in G.WIDTHS and plan.bn % 16 == 0 and plan.bn <= 256
        # the column tiles cover N, none is empty or a quarter empty
        assert plan.n_tiles * plan.bn >= N > (plan.n_tiles - 1) * plan.bn
        assert plan.n_tiles * plan.bn - N < plan.bn / 4, what
        assert plan.m_tiles * G.TILE_M >= M > (plan.m_tiles - 1) * G.TILE_M
        assert plan.k_chunk % G.TILE_K == 0
        # the K ranges cover K, none is empty
        assert plan.splits * plan.k_chunk >= K > (
            plan.splits - 1) * plan.k_chunk, what
        if layout == "dw":  # the split fills at least one wave of CTAs
            assert plan.m_tiles * plan.n_tiles * plan.splits >= sms, what
        else:
            assert plan.splits == 1


def test_gemm_wrappers_refuse_misaligned_rows():
    """Rows that do not start on 16-byte boundaries (the TMA's row
    alignment) are refused on every device, before any launch."""
    a = torch.zeros(16, 100, dtype=BF16)   # 200-byte rows
    w = torch.zeros(96, 100, dtype=BF16)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        G.linear(a, w, torch.zeros(96, dtype=BF16))
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        G.input_grad(torch.zeros(16, 96, dtype=BF16),
                     torch.zeros(96, 100, dtype=BF16), G.EPI_BF16)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        G.weight_grad(torch.zeros(16, 96, dtype=BF16),
                      torch.zeros(16, 100, dtype=BF16))
    with pytest.raises(ValueError, match="contiguous"):
        G.linear(torch.zeros(96, 16, dtype=BF16).T, torch.zeros(96, 96,
                 dtype=BF16), torch.zeros(96, dtype=BF16))
    with pytest.raises(TypeError):
        G.linear(torch.zeros(16, 96), torch.zeros(96, 96),
                 torch.zeros(96))


def test_linear_refuses_epilogues_the_kernel_has_not():
    a, w, b = (torch.zeros(16, 96, dtype=BF16),
               torch.zeros(32, 96, dtype=BF16), torch.zeros(32, dtype=BF16))
    res = torch.zeros(16, 32, dtype=BF16)
    dp = torch.ones(16)
    for kw in (dict(gelu=True, res=res), dict(keep_pre=True),
               dict(dp=dp), dict(gelu=True, dp=dp)):
        with pytest.raises(ValueError, match="epilogues"):
            G.linear(a, w, b, **kw)
    for kw in (dict(), dict(gelu=True, keep_pre=True),
               dict(res=res, dp=dp, dp_rows=1)):
        G.linear(a, w, b, **kw)


def _bf16(rng, *shape, scale=1.0):
    """The same bf16 values for torch and JAX."""
    t = torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))
    t = t.to(BF16)
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _dot(a, b):
    return jax.lax.dot_general(a, b, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.float32)


def _close(got, want, tol):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("layout", ["forward", "dx", "dw"])
def test_gemm_plain_matches_jax_products(layout):
    rng = np.random.default_rng({"forward": 0, "dx": 1, "dw": 2}[layout])
    M, N, K = 98, 48, 96
    if layout == "forward":
        a, ja = _bf16(rng, M, K)
        w, jw = _bf16(rng, N, K, scale=K ** -0.5)   # nn.Linear (out, in)
        b, jb = _bf16(rng, N, scale=0.1)
        res, jres = _bf16(rng, M, N)
        dp = torch.from_numpy(np.where(rng.random(M // 49) < 0.8, 1.25, 0.0
                                       ).astype(np.float32))
        v = _dot(ja, jw.T) + jb.astype(jnp.float32)
        # qkv: bias only
        _close(G.linear(a, w, b)[0], v.astype(jnp.bfloat16), 1e-2)
        # fc1: GELU (exact erf) on the f32 sum, pre-activation kept
        out, pre = G.linear(a, w, b, gelu=True, keep_pre=True)
        _close(out, jax.nn.gelu(v, approximate=False).astype(jnp.bfloat16),
               1e-2)
        _close(pre, v.astype(jnp.bfloat16), 1e-2)
        # proj / fc2 in training: the rounded branch times its window's
        # DropPath multiplier, rounded, plus the residual
        jdp = jnp.repeat(jnp.asarray(dp.numpy()), 49)[:, None]
        y = (v.astype(jnp.bfloat16).astype(jnp.float32) * jdp
             ).astype(jnp.bfloat16)
        _close(G.linear(a, w, b, res=res, dp=dp, dp_rows=49)[0], jres + y,
               1e-2)
    elif layout == "dx":
        dy, jdy = _bf16(rng, M, K)
        w, jw = _bf16(rng, K, N, scale=K ** -0.5)
        aux, jaux = _bf16(rng, M, N)
        acc = _dot(jdy, jw)
        _close(G.input_grad(dy, w, G.EPI_F32), acc, 1e-5)
        _close(G.input_grad(dy, w, G.EPI_BF16), acc.astype(jnp.bfloat16),
               1e-2)
        grad = jax.vmap(jax.grad(lambda x: jax.nn.gelu(x, approximate=False))
                        )(jaux.astype(jnp.float32).ravel()).reshape(M, N)
        _close(G.input_grad(dy, w, G.EPI_GELU_BWD, aux),
               (acc * grad).astype(jnp.bfloat16), 1e-2)
    else:
        dy, jdy = _bf16(rng, M, N)
        x, jx = _bf16(rng, M, K)
        out = G.weight_grad(dy, x)
        assert out.dtype == torch.float32
        _close(out, _dot(jdy.T, jx), 1e-5)
