"""The train-path kernels of the port, their plain versions and counters.

K5 :func:`window_attention_train` — differentiable window attention with the
gate-blended rel/frag bias and the seam mask on head-major (BW, h, N, hd)
q, k, v; gradients to q, k, v and to both (h, N, N) bias planes.  Replaces
``window_attention_train`` (``_train_attention_fwd_impl`` /
``_train_attention_bwd_impl``) of ``kvq_tpu/ops/window_attention.py``; on the
card ``csrc/train_attention.cu``.

K4 :func:`train_swin_block` — the whole Swin block for training: the
forward is K1's kernel sequence with per-window DropPath multipliers on its
two residual branches; when a backward can follow it keeps the
intermediates that backward reads (``KEPT``: y1, qkv, att, the row
log-sum-exp, x1, y2, the fc1 pre-activation and its GELU), and the
backward starts from them, with no recompute of the forward.  It emits dx,
the twelve weight/bias/LayerNorm gradients in float32 and the bias-plane
gradients ``drel = sum ds * gate``, ``dfrag = sum ds * (1 - gate)``.
Replaces ``train_swin_block`` (``_block_train_bwd_impl``), whose custom_vjp
keeps nothing but the inputs and recomputes, a policy for TPU memory that
the port does not follow: memory against compute is the configuration's
``checkpoint`` (``nn/swin.py``), whose ``torch.utils.checkpoint`` drops
the kept tensors and recomputes them itself.  On the card
``csrc/swin_block.cu`` (products, LayerNorm, column sums) and the
attention backward of ``csrc/train_attention.cu``.

Each is a ``torch.autograd.Function``.  For tensors on the CPU it runs its
plain versions, forward and an explicit backward written from the same
formulas and rounding points as the kernels; for CUDA tensors it launches
the kernels or raises.  ``launches`` on the forward and on the backward
wrapper count the launches of each; the four halves are spans
(``kvq.k4.fwd``, ``kvq.k4.bwd``, ``kvq.k5.fwd``, ``kvq.k5.bwd``;
``core/tracing.py``); a ``kvq.k4.fwd`` that keeps its intermediates
carries their bytes as ``kept_bytes``.  The numerics are the XLA
composition's (row-max softmax, exact-erf GELU), not the TPU kernels'
fold-softmax clamp or polynomial erf.
"""

from __future__ import annotations

import torch

from ..core.tracing import span
from . import build
from . import gemm as gemm_ops
from . import launches
from .gemm import gelu_grad
from .window_attention import (
    LN_EPS,
    _BLOCK_KEYS,
    KEPT,
    _check_cuda,
    _geometry_args,
    _ptr,
    _stream,
    _windows,
    block_forward_cuda,
    check_block_args,
    check_planes,
    flash_window_attention_plain,
    fused_swin_block_plain,
    gate_and_mask,
)

# ---------------------------------------------------------------------------
# plain versions


# K5's plain forward is K6's: the same window attention on head-major q, k, v
window_attention_train_plain = flash_window_attention_plain


def window_attention_train_bwd_plain(q, k, v, rel_bias, frag_bias, geo,
                                     scale, out, dout):
    """Plain backward of K5 from its formulas: with s = (scale q) k^T + bias
    + mask, p = softmax(s), D = rowsum(dout * out) and ds = p (dout v^T -
    D): dq = scale ds k, dk = ds^T (scale q), dv = p^T dout, drel =
    sum_windows ds * gate, dfrag = sum_windows ds * (1 - gate) (without a
    fragment bias drel = sum ds).  Rounds where the kernel does: q * scale,
    p and ds to the inputs' dtype before their products."""
    dt = q.dtype
    gate, mask = gate_and_mask(geo, q.device)
    qs = _windows((q * scale).to(dt), geo).float()
    kf, vf = _windows(k, geo).float(), _windows(v, geo).float()
    do = _windows(dout, geo).float()
    s = torch.matmul(qs, kf.transpose(-1, -2))
    if geo.use_frag:
        g = gate[:, None]
        s = s + rel_bias.float()[None] * g + frag_bias.float()[None] * (1 - g)
    else:
        s = s + rel_bias.float()[None]
    if mask is not None:
        s = s + mask[:, None]
    p = s.softmax(dim=-1)
    dsum = (do * _windows(out, geo).float()).sum(-1, keepdim=True)
    ds = p * (torch.matmul(do, vf.transpose(-1, -2)) - dsum)
    dsd = ds.to(dt).float()
    dq = (torch.matmul(dsd, kf) * scale).to(dt)
    dk = torch.matmul(dsd.transpose(-1, -2), qs).to(dt)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do).to(dt)
    if geo.use_frag:
        g = gate[:, None]
        drel = (ds * g).sum(dim=(0, 1))
        dfrag = (ds * (1 - g)).sum(dim=(0, 1))
    else:
        drel, dfrag = ds.sum(dim=(0, 1)), None
    shape = q.shape
    return (dq.reshape(shape), dk.reshape(shape), dv.reshape(shape), drel,
            dfrag)


def _ln_stats(x):
    """flax LayerNorm's xhat and 1/sigma of x's last axis, in float32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    r = torch.rsqrt(var + LN_EPS)
    return (xf - mu) * r, r


def layer_norm_bwd_plain(dy, x, weight):
    """dL/dx of flax LayerNorm (float32): r (dxhat - mean(dxhat) - xhat
    mean(dxhat xhat)) with dxhat = dy * weight; also dweight, dbias."""
    xhat, r = _ln_stats(x)
    dxh = dy * weight.float()
    m1 = dxh.mean(-1, keepdim=True)
    m2 = (dxh * xhat).mean(-1, keepdim=True)
    rows = dy.reshape(-1, dy.shape[-1])
    return (r * (dxh - m1 - xhat * m2),
            (rows * xhat.reshape(rows.shape)).sum(0), rows.sum(0))


def _rows(t):
    return t.reshape(-1, t.shape[-1]).float()


def _heads(t, h):
    """(BW, N, C) -> (BW, h, N, hd)."""
    BW, N, C = t.shape
    return t.reshape(BW, N, h, C // h).transpose(1, 2)


def train_swin_block_bwd_plain(x, params, rel_bias, frag_bias, geo, scale,
                               dp1, dp2, kept, dout):
    """Plain backward of K4, from the formulas and rounding points of the
    kernel sequence, starting from ``kept`` (the plain forward's, under
    ``KEPT``): the products backward (f32 weight gradients from the rounded
    operands), the GELU derivative, the LayerNorm backward, and K5's
    attention backward.  Returns (dx, {key: grad}, drel, dfrag)."""
    dt = x.dtype
    BW, N, C = x.shape
    h = geo.num_heads
    p = params
    y1, qkv, att, x1, y2, pre, g1 = (
        kept[k] for k in ("y1", "qkv", "att", "x1", "y2", "pre", "hmid"))
    q, k, v = (_heads(t, h).contiguous() for t in qkv.split(C, dim=-1))

    rs1 = dp1.float()[:, None, None]
    rs2 = dp2.float()[:, None, None]
    g = {}
    dm2 = dout.float() * rs2
    dm2d = dm2.to(dt)
    g["fc2_b"] = _rows(dm2).sum(0)
    g["fc2_w"] = _rows(dm2d).T @ _rows(g1)
    dh1 = ((dm2d.float() @ p["fc2_w"].float()) * gelu_grad(pre)).to(dt)
    g["fc1_b"] = _rows(dh1).sum(0)
    g["fc1_w"] = _rows(dh1).T @ _rows(y2)
    dy2 = dh1.float() @ p["fc1_w"].float()
    dln, g["norm2_scale"], g["norm2_bias"] = layer_norm_bwd_plain(
        dy2, x1, p["norm2_scale"])
    dx1 = dout.float() + dln
    datt = dx1 * rs1
    dattd = datt.to(dt)
    g["proj_b"] = _rows(datt).sum(0)
    g["proj_w"] = _rows(dattd).T @ _rows(att)
    dao = (dattd.float() @ p["proj_w"].float()).to(dt)
    dq, dk, dv, drel, dfrag = window_attention_train_bwd_plain(
        q, k, v, rel_bias, frag_bias, geo, scale, _heads(att, h),
        _heads(dao, h))
    dqkv = torch.cat([t.transpose(1, 2).reshape(BW, N, C)
                      for t in (dq, dk, dv)], dim=-1)
    g["qkv_b"] = _rows(dqkv).sum(0)
    g["qkv_w"] = _rows(dqkv).T @ _rows(y1)
    dy1 = dqkv.float() @ p["qkv_w"].float()
    dln, g["norm1_scale"], g["norm1_bias"] = layer_norm_bwd_plain(
        dy1, x, p["norm1_scale"])
    dx = (dx1 + dln).to(dt)
    return dx, g, drel, dfrag


# ---------------------------------------------------------------------------
# CUDA wrappers


def _check_attention(name, q, k, v, rel_bias, frag_bias, geo):
    BW, h, N, hd = q.shape
    if (h != geo.num_heads or hd != geo.head_dim or N != geo.n_tokens
            or BW != geo.batch * geo.n_windows):
        raise ValueError(f"{name}: q {tuple(q.shape)} does not match {geo}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k and v must have one shape")
    check_planes(name, rel_bias, frag_bias, geo)
    if q.device.type == "cpu":
        return
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"{name}: q, k and v must be bfloat16 on CUDA")
    if hd != 32:
        raise ValueError(f"{name}: unsupported head_dim {hd} (the backward "
                         "kernel takes 32, the head_dim of every stage)")
    _check_cuda(name, q.device, q=q, k=k, v=v, rel_bias=rel_bias,
                frag_bias=frag_bias)


@span("kvq.k5.fwd")
def window_attention_train_fwd(q, k, v, rel_bias, frag_bias, geo, scale):
    """K5's forward: (out, row log-sum-exp) on CUDA (the lse is what the
    backward kernel reads), (out, None) on the CPU."""
    _check_attention("window_attention_train", q, k, v, rel_bias, frag_bias,
                     geo)
    if q.device.type == "cpu":
        return window_attention_train_plain(q, k, v, rel_bias, frag_bias,
                                            geo, scale), None
    BW, h, N, hd = q.shape
    dev = q.device
    out = torch.empty_like(q)
    lse = torch.empty((BW, h, N), dtype=torch.float32, device=dev)
    lib = build.load("train_attention")
    with torch.cuda.device(dev):
        build.check(lib.kvq_window_attention_train(
            _ptr(q), _ptr(k), _ptr(v), _ptr(rel_bias), _ptr(frag_bias),
            _ptr(out), _ptr(lse), BW, N, h, hd, *_geometry_args(geo),
            float(scale), _stream(dev),
        ), "window_attention_train")
    window_attention_train.launches += 1
    return out, lse


def _attention_bwd_cuda(q, k, v, out, dout, lse, rel_bias, frag_bias, geo,
                        scale, packed, grads):
    """The attention backward kernels into ``grads`` = (dq, dk, dv, drel,
    dfrag): pointers of the two layouts (head-major or K4's packed qkv)."""
    BW, h, N, hd = geo.batch * geo.n_windows, geo.num_heads, geo.n_tokens, \
        geo.head_dim
    dev = dout.device
    dsum = torch.empty((BW, h, N), dtype=torch.float32, device=dev)
    lib = build.load("train_attention")
    build.check(lib.kvq_window_attention_bwd(
        q, k, v, _ptr(out), _ptr(dout), _ptr(lse), _ptr(dsum),
        *grads[:3], _ptr(grads[3]), _ptr(grads[4]), _ptr(rel_bias),
        _ptr(frag_bias), BW, N, h, hd, int(packed), *_geometry_args(geo),
        float(scale), _stream(dev),
    ), "window attention backward")


@launches.counted
@span("kvq.k5.bwd")
def window_attention_train_bwd(q, k, v, rel_bias, frag_bias, geo, scale,
                               out, lse, dout):
    """K5's backward: (dq, dk, dv, drel, dfrag); the kernels on CUDA, the
    plain version on the CPU."""
    if q.device.type == "cpu":
        return window_attention_train_bwd_plain(q, k, v, rel_bias, frag_bias,
                                                geo, scale, out, dout)
    _check_cuda("window_attention_train_bwd", q.device, out=out, lse=lse,
                dout=dout)
    if dout.dtype != torch.bfloat16:
        raise TypeError("window_attention_train_bwd: dout must be bfloat16")
    dev = q.device
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    drel = torch.zeros_like(rel_bias)
    dfrag = None if frag_bias is None else torch.zeros_like(frag_bias)
    with torch.cuda.device(dev):
        _attention_bwd_cuda(_ptr(q), _ptr(k), _ptr(v), out, dout, lse,
                            rel_bias, frag_bias, geo, scale, False,
                            (_ptr(dq), _ptr(dk), _ptr(dv), drel, dfrag))
    window_attention_train_bwd.launches += 1
    return dq, dk, dv, drel, dfrag


class _WindowAttentionTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rel_bias, frag_bias, geo, scale):
        out, lse = window_attention_train_fwd(q, k, v, rel_bias, frag_bias,
                                              geo, scale)
        ctx.geo, ctx.scale = geo, scale
        ctx.save_for_backward(q, k, v, rel_bias, frag_bias, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, rel, frag, out, lse = ctx.saved_tensors
        dq, dk, dv, drel, dfrag = window_attention_train_bwd(
            q, k, v, rel, frag, ctx.geo, ctx.scale, out, lse,
            dout.contiguous())
        return dq, dk, dv, drel.to(rel.dtype), (
            None if frag is None else dfrag.to(frag.dtype)), None, None


@launches.counted
def window_attention_train(q, k, v, rel_bias, frag_bias, geo, scale=None):
    """K5.  q/k/v: (BW, h, N, hd); rel/frag: (h, N, N) float32 planes (frag
    None without a fragment bias).  Returns (BW, h, N, hd); differentiable
    in q, k, v and both planes."""
    scale = geo.head_dim ** -0.5 if scale is None else float(scale)
    return _WindowAttentionTrain.apply(q, k, v, rel_bias, frag_bias, geo,
                                       scale)


def _dp(dp, BW, device):
    dp = dp.reshape(-1).float().contiguous()
    if dp.shape[0] != BW or dp.device != device:
        raise ValueError(f"train_swin_block: DropPath multipliers must be "
                         f"({BW},) on {device}")
    return dp


def kept_bytes(x, params, geo) -> int:
    """The bytes K4's forward keeps for its backward at ``x``: six (M, C)
    or (M, 3C) activations and two (M, hidden) in x's dtype, and on CUDA
    the (BW, h, N) float32 row log-sum-exp."""
    BW, N, C = x.shape
    hidden = params["fc1_w"].shape[0]
    lse = 4 * BW * geo.num_heads * N if x.device.type == "cuda" else 0
    return x.element_size() * BW * N * (7 * C + 2 * hidden) + lse


def train_swin_block_fwd(x, params, rel_bias, frag_bias, geo, scale, dp1,
                         dp2, keep=False):
    """K4's forward (the plain version on the CPU); with ``keep`` (out,
    kept), the intermediates its backward reads under ``KEPT``, and the
    span carries their ``kept_bytes``."""
    attrs = {"kept_bytes": kept_bytes(x, params, geo)} if keep else {}
    with span("kvq.k4.fwd", **attrs):
        if x.device.type == "cpu":
            return fused_swin_block_plain(x, params, rel_bias, frag_bias,
                                          geo, scale, dp1, dp2, keep)
        if x.device.type != "cuda":
            raise ValueError(f"train_swin_block: unsupported device "
                             f"{x.device}")
        check_block_args("train_swin_block", x, params, rel_bias, frag_bias,
                         geo)
        if geo.head_dim != 32:
            raise ValueError("train_swin_block: the backward kernel takes "
                             "head_dim 32, the head_dim of every stage")
        out = block_forward_cuda(x, params, rel_bias, frag_bias, geo, scale,
                                 dp1, dp2, keep)
        train_swin_block.launches += 1
        return out


@launches.counted
@span("kvq.k4.bwd")
def train_swin_block_bwd(x, params, rel_bias, frag_bias, geo, scale, dp1,
                         dp2, kept, dout):
    """K4's backward from ``kept``, what the forward kept under ``KEPT``:
    (dx, {key: f32 grad}, drel, dfrag); the kernel sequence on CUDA, the
    plain version on the CPU."""
    if x.device.type == "cpu":
        return train_swin_block_bwd_plain(x, params, rel_bias, frag_bias,
                                          geo, scale, dp1, dp2, kept, dout)
    check_block_args("train_swin_block_bwd", x, params, rel_bias, frag_bias,
                     geo)
    _check_cuda("train_swin_block_bwd", x.device, dout=dout, **kept)
    if dout.dtype != torch.bfloat16:
        raise TypeError("train_swin_block_bwd: dout must be bfloat16")
    BW, N, C = x.shape
    h, hd = geo.num_heads, geo.head_dim
    M = BW * N
    dev = x.device
    p = params
    hidden = p["fc1_w"].shape[0]
    lib = build.load("swin_block")
    glib = build.load("gemm")
    stream = _stream(dev)
    sms = gemm_ops.sm_count(dev.index)
    f32, bf = torch.float32, torch.bfloat16

    def zeros(*shape):
        return torch.zeros(shape, dtype=f32, device=dev)

    def weight_grad(dy, xin, n_out, n_in):
        """f32 (n_out, n_in) = dy^T @ xin over the M rows, split along M."""
        out = zeros(n_out, n_in)
        gemm_ops.launch_weight_grad(glib, stream, sms, _ptr(dy), _ptr(xin),
                                    _ptr(out), n_out, n_in, M)
        return out

    def input_grad(dy, w, n_in, k, epi, aux=None):
        """dy (M, k) @ w (k, n_in): f32 (EPI_F32), bf16 (EPI_BF16), or bf16
        times the GELU derivative at ``aux`` (EPI_GELU_BWD)."""
        f32_out = epi == gemm_ops.EPI_F32
        out = torch.empty((M, n_in), dtype=f32 if f32_out else bf,
                          device=dev)
        gemm_ops.launch_input_grad(
            glib, stream, sms, _ptr(dy), _ptr(w), _ptr(aux),
            None if f32_out else _ptr(out), _ptr(out) if f32_out else None,
            M, n_in, k, epi)
        return out

    def colsum(a, dp=None):
        out = zeros(a.shape[-1])
        build.check(lib.kvq_colsum(
            _ptr(a), int(a.dtype == f32), _ptr(dp), N, _ptr(out), M,
            a.shape[-1], stream), "train_swin_block column sum")
        return out

    def ln_bwd(xin, gamma, dy, res, out_dtype, dp=None):
        dx = torch.empty((M, C), dtype=out_dtype, device=dev)
        dg, db = zeros(C), zeros(C)
        scaled = torch.empty((M, C), dtype=bf, device=dev) if dp is not None \
            else None
        build.check(lib.kvq_layernorm_bwd(
            _ptr(xin), _ptr(gamma), _ptr(dy), _ptr(res),
            int(res.dtype == f32), _ptr(dx), int(out_dtype == f32),
            _ptr(dg), _ptr(db), _ptr(dp), N, _ptr(scaled), M, C, LN_EPS,
            stream), "train_swin_block layernorm backward")
        return dx, dg, db, scaled

    g = {}
    with torch.cuda.device(dev):
        dout = dout.reshape(M, C)
        g["fc2_b"] = colsum(dout, dp2)
        dm2 = torch.empty((M, C), dtype=bf, device=dev)
        build.check(lib.kvq_scale_rows(_ptr(dout), _ptr(dp2), N, _ptr(dm2),
                                       M, C, stream),
                    "train_swin_block scale rows")
        g["fc2_w"] = weight_grad(dm2, kept["hmid"], C, hidden)
        dh1 = input_grad(dm2, p["fc2_w"], hidden, C, gemm_ops.EPI_GELU_BWD,
                         kept["pre"])
        g["fc1_b"] = colsum(dh1)
        g["fc1_w"] = weight_grad(dh1, kept["y2"], hidden, C)
        dy2 = input_grad(dh1, p["fc1_w"], C, hidden, gemm_ops.EPI_F32)
        dx1, g["norm2_scale"], g["norm2_bias"], datt = ln_bwd(
            kept["x1"], p["norm2_scale"], dy2, dout, f32, dp1)
        g["proj_b"] = colsum(dx1, dp1)
        g["proj_w"] = weight_grad(datt, kept["att"], C, C)
        dao = input_grad(datt, p["proj_w"], C, C, gemm_ops.EPI_BF16)
        dqkv = torch.empty((M, 3 * C), dtype=bf, device=dev)
        drel = torch.zeros_like(rel_bias)
        dfrag = None if frag_bias is None else torch.zeros_like(frag_bias)
        qkv, dq, el = kept["qkv"].data_ptr(), dqkv.data_ptr(), 2 * C
        _attention_bwd_cuda(qkv, qkv + el, qkv + 2 * el, kept["att"], dao,
                            kept["lse"], rel_bias, frag_bias, geo, scale, True,
                            (dq, dq + el, dq + 2 * el, drel, dfrag))
        g["qkv_b"] = colsum(dqkv)
        g["qkv_w"] = weight_grad(dqkv, kept["y1"], 3 * C, C)
        dy1 = input_grad(dqkv, p["qkv_w"], C, 3 * C, gemm_ops.EPI_F32)
        dx, g["norm1_scale"], g["norm1_bias"], _ = ln_bwd(
            x, p["norm1_scale"], dy1, dx1, bf)
    train_swin_block_bwd.launches += 1
    return dx.view(BW, N, C), g, drel, dfrag


class _TrainSwinBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rel_bias, frag_bias, dp1, dp2, geo, scale, keep,
                *weights):
        params = dict(zip(_BLOCK_KEYS, weights))
        if not keep:  # no backward can follow: nothing to keep
            return train_swin_block_fwd(x, params, rel_bias, frag_bias, geo,
                                        scale, dp1, dp2)
        out, kept = train_swin_block_fwd(x, params, rel_bias, frag_bias,
                                         geo, scale, dp1, dp2, keep=True)
        ctx.geo, ctx.scale = geo, scale
        ctx.save_for_backward(x, rel_bias, frag_bias, dp1, dp2, *weights,
                              *(kept[k] for k in KEPT))
        return out

    @staticmethod
    def backward(ctx, dout):
        x, rel, frag, dp1, dp2, *rest = ctx.saved_tensors
        weights = rest[:len(_BLOCK_KEYS)]
        kept = dict(zip(KEPT, rest[len(_BLOCK_KEYS):]))
        params = dict(zip(_BLOCK_KEYS, weights))
        dx, g, drel, dfrag = train_swin_block_bwd(
            x, params, rel, frag, ctx.geo, ctx.scale, dp1, dp2, kept,
            dout.contiguous())
        dw = [g[k].reshape(w.shape).to(w.dtype)
              for k, w in zip(_BLOCK_KEYS, weights)]
        return (dx, drel.to(rel.dtype),
                None if frag is None else dfrag.to(frag.dtype),
                None, None, None, None, None, *dw)


@launches.counted
def train_swin_block(x, params, rel_bias, frag_bias, geo, dp1, dp2,
                     scale=None):
    """K4.  x: (BW, N, C) partitioned, rolled tokens; params under K1's keys
    (nn.Linear layout); rel/frag (h, N, N) float32 planes; dp1/dp2: (BW,)
    or (BW, 1) DropPath multipliers (mask / keep per window; ones when the
    rate is 0).  Returns the block output (BW, N, C), differentiable in x,
    every weight and both planes."""
    BW, N, C = x.shape
    if (C != geo.num_heads * geo.head_dim or N != geo.n_tokens
            or BW != geo.batch * geo.n_windows):
        raise ValueError(f"train_swin_block: x {tuple(x.shape)} does not "
                         f"match {geo}")
    if (frag_bias is not None) != geo.use_frag:
        raise ValueError("train_swin_block: frag_bias must be given exactly "
                         "when geo.use_frag")
    scale = geo.head_dim ** -0.5 if scale is None else float(scale)
    dp1, dp2 = _dp(dp1, BW, x.device), _dp(dp2, BW, x.device)
    weights = [params[k] for k in _BLOCK_KEYS]
    keep = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (x, rel_bias, frag_bias, *weights))
    return _TrainSwinBlock.apply(x, rel_bias, frag_bias, dp1, dp2, geo,
                                 scale, keep, *weights)
