"""The Swin block's products on the card, their plain versions and the tile
plan.

Every product of K1 (``fused_swin_block``) and K4 (``train_swin_block``,
forward and backward) runs one GEMM, ``csrc/gemm.cuh`` behind
the C entries ``kvq_gemm`` and ``kvq_gemm_bwd`` of ``csrc/gemm.cu``,
in three layouts (they replace the ``jax.lax.dot_general`` calls in the
block kernels of ``kvq_tpu/ops/window_attention.py``):

- forward: ``out = epi(a @ w.T + bias)``, a (M, K), w (N, K) as nn.Linear
  keeps it; the epilogue adds the bias, keeps the pre-activation, applies
  the exact-erf GELU, the per-row DropPath multiplier and the residual;
- dX: ``out = epi(dy @ w)``, dy (M, K), w (K, N); out in f32, in bf16, or
  in bf16 times the GELU derivative at the pre-activation;
- dW: ``out = dy.T @ x`` in f32, dy (R, n_out), x (R, n_in), the token rows
  R split over the card.

:func:`plan_gemm` picks each product's tile width and dW's split on the
host; it is the one place where that choice is made.  The K1/K4 paths call
the launchers (``launch_*``) with their own checked tensors; the wrappers
:func:`linear`, :func:`input_grad` and :func:`weight_grad` check their
operands on every device (so that the CPU sees their refusals), run the
plain version for tensors on the CPU and launch the kernel for CUDA tensors.
The plain versions round where the kernel does.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from . import build

WIDTHS = (96, 128, 144, 192)  # the tile widths csrc/gemm.cuh builds
TILE_M = 128   # output rows per tile
TILE_K = 64    # k per ring stage
EPI_F32, EPI_BF16, EPI_GELU_BWD = 1, 3, 4  # dX epilogues (csrc/gemm.cuh)
LAYOUTS = ("forward", "dx", "dw")


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    bn: int        # tile width
    m_tiles: int
    n_tiles: int
    k_chunk: int   # K per split, a multiple of TILE_K
    splits: int    # dW: K ranges summed with atomics; 1 otherwise


@functools.lru_cache(maxsize=1024)
def plan_gemm(layout: str, M: int, N: int, K: int, sms: int = 132
              ) -> GemmPlan:
    """The tiles of one product: out (M, N), reduction K (for dW, M = n_out,
    N = n_in and K the token rows).  The width minimises the waves of
    128 x BN tiles times a tile's cost, ``BN + 64`` (its B columns plus the
    A rows and epilogue that every tile pays), over the card's ``sms``
    persistent CTAs (wide tiles where M is large, narrower ones where wide
    tiles would leave SMs idle), among the widths whose last tile is less
    than a quarter empty where N has one.  dW splits K into ranges of whole
    k-tiles until the units cover two per SM."""
    if layout not in LAYOUTS:
        raise ValueError(f"plan_gemm: unknown layout {layout!r}")
    if min(M, N, K) <= 0 or N % 8:
        raise ValueError(f"plan_gemm: unsupported shape M={M} N={N} K={K} "
                         "(N must be a positive multiple of 8)")
    m_tiles = -(-M // TILE_M)
    # widths whose last tile is less than a quarter empty, where there is one
    widths = [b for b in WIDTHS if -(-N // b) * b - N < b / 4] or WIDTHS

    def cost(bn):
        n_tiles = -(-N // bn)
        if layout == "dw":  # the split fills the card
            return n_tiles * (bn + 64)
        return -(-m_tiles * n_tiles // sms) * (bn + 64)

    bn = min(widths, key=lambda b: (cost(b), -b))
    n_tiles = -(-N // bn)
    k_tiles = -(-K // TILE_K)
    splits = 1
    if layout == "dw":
        splits = max(1, min(k_tiles, -(-2 * sms // (m_tiles * n_tiles))))
    chunk = -(-k_tiles // splits)
    return GemmPlan(bn, m_tiles, n_tiles, chunk * TILE_K, -(-k_tiles // chunk))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


# ---------------------------------------------------------------------------
# plain versions


def gelu_grad(x):
    """d GELU(x) / dx for the exact-erf GELU, float32."""
    xf = x.float()
    return (0.5 * (1 + torch.erf(xf * 2 ** -0.5))
            + xf * torch.exp(-0.5 * xf * xf) * (2 * math.pi) ** -0.5)


def linear_plain(a, w, bias, res=None, gelu=False, dp=None, dp_rows=1):
    """The forward product's plain version: (out, pre), both bf16.  The f32
    sum plus the bias is the pre-activation; GELU acts on the f32 value; the
    branch is rounded, scaled by ``dp[row // dp_rows]``, rounded again and
    added to the residual."""
    bf = torch.bfloat16
    v = a.float() @ w.float().T + bias.float()
    pre = v.to(bf)
    y = (F.gelu(v) if gelu else v).to(bf)
    if dp is not None:
        rows = torch.arange(a.shape[0], device=a.device) // dp_rows
        y = (y.float() * dp.float()[rows, None]).to(bf)
    if res is not None:
        y = (res.float() + y.float()).to(bf)
    return y, pre


def input_grad_plain(dy, w, epi, aux=None):
    """dX's plain version: dy @ w in f32, then f32 out, bf16 out, or bf16 of
    the product times the GELU derivative at ``aux``."""
    acc = dy.float() @ w.float()
    if epi == EPI_F32:
        return acc
    if epi == EPI_GELU_BWD:
        acc = acc * gelu_grad(aux)
    return acc.to(torch.bfloat16)


def weight_grad_plain(dy, x):
    """dW's plain version: dy.T @ x over the token rows, f32."""
    return dy.float().T @ x.float()


# ---------------------------------------------------------------------------
# launchers (operands checked by the caller)


def launch_forward(lib, stream, sms, a, w, bias, res, out, M, N, K, gelu,
                   dp, dp_rows, pre, bn=None):
    """kvq_gemm on data pointers (ints, or None); ``bn`` overrides the
    plan's tile width."""
    plan = plan_gemm("forward", M, N, K, sms)
    build.check(lib.kvq_gemm(a, w, bias, res, out, M, N, K, int(gelu), dp,
                             dp_rows, pre, bn or plan.bn, stream),
                "swin block gemm")


def launch_input_grad(lib, stream, sms, dy, w, aux, out, out_f32, M, N, K,
                      epi, bn=None):
    """kvq_gemm_bwd's dX layout on data pointers."""
    plan = plan_gemm("dx", M, N, K, sms)
    build.check(lib.kvq_gemm_bwd(dy, w, aux, out, out_f32, M, N, K, 0, epi,
                                 bn or plan.bn, plan.k_chunk, stream),
                "swin block input gradient")


def launch_weight_grad(lib, stream, sms, dy, x, out_f32, n_out, n_in, rows,
                       bn=None):
    """kvq_gemm_bwd's dW layout on data pointers; adds into ``out_f32``."""
    plan = plan_gemm("dw", n_out, n_in, rows, sms)
    build.check(lib.kvq_gemm_bwd(dy, x, None, None, out_f32, n_out, n_in,
                                 rows, 1, 0, bn or plan.bn, plan.k_chunk,
                                 stream),
                "swin block weight gradient")


# ---------------------------------------------------------------------------
# checked wrappers


def _check(name, device, **operands):
    """2-D bf16 row-major operands whose rows start on 16-byte boundaries
    (the TMA reads rows at 16-byte granularity), on one device."""
    for key, t in operands.items():
        if t is None:
            continue
        if t.dim() != 2 or t.stride(1) != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be a contiguous matrix")
        if t.stride(0) * t.element_size() % 16:
            raise ValueError(
                f"{name}: {key}'s row stride of "
                f"{t.stride(0) * t.element_size()} bytes is not a multiple "
                "of 16 bytes")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {key} must be bfloat16")
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{device}")
        if t.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")


def _shape(name, key, t, shape):
    if t is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name}: {key} is {tuple(t.shape)}, expected "
                         f"{shape}")


def _ctx(device):
    return (build.load("gemm"),
            torch.cuda.current_stream(device).cuda_stream,
            sm_count(device.index))


def _p(t):
    return None if t is None else t.data_ptr()


def linear(a, w, bias, res=None, gelu=False, dp=None, dp_rows=1,
           keep_pre=False, bn=None):
    """The forward product of K1 and K4: (out, pre) with out = [res +]
    [dp[row // dp_rows] *] [GELU](a @ w.T + bias) and pre = a @ w.T + bias
    (None unless ``keep_pre``), bf16; GELU goes without the residual, the
    pre-activation only with GELU, dp only with the residual.  a (M, K),
    w (N, K), bias (N,), res (M, N), dp f32.  ``bn`` (one of WIDTHS)
    overrides the plan's tile width, here and in the other wrappers."""
    M, K = a.shape
    N = w.shape[0]
    _check("linear", a.device, a=a, w=w, res=res, bias=bias.view(1, -1))
    _shape("linear", "w", w, (N, K))
    _shape("linear", "bias", bias, (N,))
    _shape("linear", "res", res, (M, N))
    if N % 8:
        raise ValueError(f"linear: N={N} is not a multiple of 8")
    if (gelu and (res is not None or dp is not None)
            or keep_pre and not gelu or dp is not None and res is None):
        raise ValueError("linear: the epilogues are bias, GELU (keeping the "
                         "pre-activation or not) and the residual (with "
                         "DropPath multipliers or not)")
    if a.device.type == "cpu":
        out, pre = linear_plain(a, w, bias, res, gelu, dp, dp_rows)
        return out, pre if keep_pre else None
    dp = None if dp is None else dp.float().contiguous()
    if dp is not None and (dp.device != a.device
                           or dp.numel() * dp_rows < M):
        raise ValueError("linear: dp must hold one multiplier per "
                         f"{dp_rows} rows on {a.device}")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=a.device)
    pre = torch.empty_like(out) if keep_pre else None
    with torch.cuda.device(a.device):
        lib, stream, sms = _ctx(a.device)
        launch_forward(lib, stream, sms, _p(a), _p(w), _p(bias), _p(res),
                       _p(out), M, N, K, gelu, _p(dp), dp_rows, _p(pre), bn)
    return out, pre


def input_grad(dy, w, epi, aux=None, bn=None):
    """dX of K4: dy (M, K) @ w (K, N) with the epilogue ``epi``
    (EPI_F32: f32 out; EPI_BF16; EPI_GELU_BWD: bf16 of the product times
    GELU'(aux), aux the (M, N) pre-activation)."""
    M, K = dy.shape
    N = w.shape[1]
    if epi not in (EPI_F32, EPI_BF16, EPI_GELU_BWD):
        raise ValueError(f"input_grad: unknown epilogue {epi}")
    if (aux is None) != (epi != EPI_GELU_BWD):
        raise ValueError("input_grad: aux is given exactly with EPI_GELU_BWD")
    _check("input_grad", dy.device, dy=dy, w=w, aux=aux)
    _shape("input_grad", "w", w, (K, N))
    _shape("input_grad", "aux", aux, (M, N))
    if dy.device.type == "cpu":
        return input_grad_plain(dy, w, epi, aux)
    out = torch.empty((M, N), dtype=torch.float32 if epi == EPI_F32
                      else torch.bfloat16, device=dy.device)
    f32 = epi == EPI_F32
    with torch.cuda.device(dy.device):
        lib, stream, sms = _ctx(dy.device)
        launch_input_grad(lib, stream, sms, _p(dy), _p(w), _p(aux),
                          None if f32 else _p(out), _p(out) if f32 else None,
                          M, N, K, epi, bn)
    return out


def weight_grad(dy, x, bn=None):
    """dW of K4: dy.T @ x over the token rows, f32 (n_out, n_in); dy (R,
    n_out), x (R, n_in)."""
    R, n_out = dy.shape
    n_in = x.shape[1]
    _check("weight_grad", dy.device, dy=dy, x=x)
    _shape("weight_grad", "x", x, (R, n_in))
    if dy.device.type == "cpu":
        return weight_grad_plain(dy, x)
    out = torch.zeros((n_out, n_in), dtype=torch.float32, device=dy.device)
    with torch.cuda.device(dy.device):
        lib, stream, sms = _ctx(dy.device)
        launch_weight_grad(lib, stream, sms, _p(dy), _p(x), _p(out), n_out,
                           n_in, R, bn)
    return out
