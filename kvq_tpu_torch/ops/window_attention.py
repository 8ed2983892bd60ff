"""The eval-path kernels of the port, their plain versions and counters.

K1 :func:`fused_swin_block` — one whole Swin block over partitioned, rolled
tokens (LN1 -> qkv -> window attention with the gate-blended rel/frag bias
and the seam mask -> proj -> +res -> LN2 -> MLP(GELU) -> +res).  Replaces
``fused_swin_block`` of ``kvq_tpu/ops/window_attention.py``; on the card it
is a sequence of this repository's CUDA kernels (``csrc/swin_block.cu``:
a LayerNorm pass, the wgmma GEMM of ``csrc/gemm.cuh`` with bias/GELU/residual
epilogues (:mod:`.gemm`), and the flash window attention of
``csrc/flash_attention.cuh``).

K2 :func:`flash_attention_nobias_cl` — batched multi-head attention with no
bias or mask in channel layout, the CDM attentions.  Replaces
``flash_attention_nobias_cl``; on the card ``csrc/nobias_attention.cu``.

K3 :func:`flash_window_attention_packed` — the window attention alone, on
the (BW, N, 3C) qkv product, for the eval blocks that K1 declines (token
volumes that pad to the window: every block of the Swin-T-3D model keys at
the KVQ view); on the card the window attention entry of
``csrc/swin_block.cu`` that K1 runs.  K6 :func:`flash_window_attention` is
the same attention on head-major q, k, v and K7
:func:`flash_attention_nobias` is K2 on head-major tensors; on the card
``csrc/eval_attention.cu``, the flash template read through the strides of
each layout.  Each replaces the function of the same name.

Each wrapper takes its plain PyTorch version for tensors that lie on the CPU
and launches its kernel for CUDA tensors, raising on anything the kernel
does not take; there is no fallback.  ``launches`` on each wrapper counts
kernel launches (one per call that reaches the card).

The plain versions compute the XLA composition of the JAX package (row-max
softmax, exact-erf GELU): the TPU kernels' fold-softmax, p-clamp and
polynomial GELU are TPU choices and are not ported.
"""

from __future__ import annotations

import dataclasses
import functools
import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.layers import LN_EPS, layer_norm
from . import build
from . import gemm as gemm_ops


@dataclasses.dataclass(frozen=True)
class WindowGeometry:
    batch: int
    dims: tuple[int, int, int]        # padded token volume (Dp, Hp, Wp)
    window: tuple[int, int, int]      # effective window (wd, wh, ww)
    shift: tuple[int, int, int]       # effective shift
    fragments: tuple[int, int, int]   # fragment grid (1, 7, 7)
    num_heads: int
    head_dim: int
    use_frag: bool

    @property
    def n_tokens(self) -> int:
        wd, wh, ww = self.window
        return wd * wh * ww

    @property
    def wgrid(self) -> tuple[int, int, int]:
        return tuple(d // w for d, w in zip(self.dims, self.window))

    @property
    def n_windows(self) -> int:
        gd, gh, gw = self.wgrid
        return gd * gh * gw


@functools.lru_cache(maxsize=64)
def window_token_ids(dims, window, shift, fragments):
    """Per-window token ids of one batch element: ``(fid (nW, N, 3),
    seg (nW, N))`` — the fragment id of each token's pre-roll coordinate
    on every axis, ``((g + shift) mod Dim) * F // Dim``, and its seam
    segment ``segd*9 + segh*3 + segw`` in the rolled frame."""
    wd, wh, ww = window
    n = wd * wh * ww
    tok = np.arange(n)
    offs = (tok // (wh * ww), (tok // ww) % wh, tok % ww)
    fids, segs = [], []
    for ax in range(3):
        dim, w, s, f = dims[ax], window[ax], shift[ax], fragments[ax]
        g = np.arange(dim // w)[:, None] * w + offs[ax][None, :]
        fids.append(((g + s) % dim) * f // dim)
        segs.append(np.where(g < dim - w, 0, np.where(g < dim - s, 1, 2)))
    fd, fh, fw = (a.reshape(a.shape[0], 1, 1, n) if i == 0 else
                  a.reshape(1, a.shape[0], 1, n) if i == 1 else
                  a.reshape(1, 1, a.shape[0], n)
                  for i, a in enumerate(fids))
    fid = np.stack(np.broadcast_arrays(fd, fh, fw), axis=-1).reshape(-1, n, 3)
    sd, sh, sw = segs
    seg = (sd[:, None, None, :] * 9 + sh[None, :, None, :] * 3
           + sw[None, None, :, :]).reshape(-1, n)
    return fid.astype(np.int64), seg.astype(np.int64)


def gate_and_mask(geo: WindowGeometry, device):
    """(nW, N, N) fragment gate (the unclamped sum of |Δ fragment id| — a
    reference quirk: it can exceed 1) and additive seam mask (-100 across
    shifted-window seams, or None when unshifted), built on ``device``."""
    fid, seg = window_token_ids(geo.dims, geo.window, geo.shift, geo.fragments)
    fid = torch.as_tensor(fid, device=device, dtype=torch.float32)
    gate = 0
    for a in range(3):
        gate = gate + (fid[:, :, None, a] - fid[:, None, :, a]).abs()
    mask = None
    if any(geo.shift):
        seg = torch.as_tensor(seg, device=device)
        mask = torch.where(seg[:, :, None] != seg[:, None, :], -100.0, 0.0)
    return gate, mask


def window_attention_plain(q, k, v, rel_bias, frag_bias, gate, mask, scale,
                           dropout=None):
    """XLA composition of window attention (nn/swin.py WindowAttention3D).
    q/k/v: (B, nW, h, N, hd); rel/frag: (h, N, N) f32; gate/mask:
    (nW, N, N) or None; ``dropout``: applied to the float32 attention
    weights (a training forward's).  Returns (B, nW, h, N, hd) in
    float32."""
    attn = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    if frag_bias is not None and gate is not None:
        g = gate[:, None]
        bias = rel_bias[None] * g + frag_bias[None] * (1.0 - g)
    else:
        bias = rel_bias[None]
    attn = attn + bias
    if mask is not None:
        attn = attn + mask[:, None]
    p = attn.softmax(dim=-1)
    if dropout is not None:
        p = dropout(p)
    return torch.matmul(p.to(v.dtype).float(), v.float())


def _windows(t, geo):
    """(BW, ...) -> (B, nW, ...)."""
    nW = geo.n_windows
    return t.reshape(t.shape[0] // nW, nW, *t.shape[1:])


def flash_window_attention_plain(q, k, v, rel_bias, frag_bias, geo, scale):
    """Plain version of K6 (and K5's forward): head-major q/k/v
    (BW, h, N, hd) -> (BW, h, N, hd) in q's dtype."""
    gate, mask = gate_and_mask(geo, q.device)
    out = window_attention_plain(
        _windows(q, geo), _windows(k, geo), _windows(v, geo),
        rel_bias.float(), None if frag_bias is None else frag_bias.float(),
        gate if geo.use_frag else None, mask, scale)
    return out.reshape(q.shape).to(q.dtype)


def flash_window_attention_packed_plain(qkv, rel_bias, frag_bias, geo,
                                        scale):
    """Plain version of K3: qkv (BW, N, 3C) as nn.Linear emits it ->
    (BW, N, C) in qkv's dtype, heads concatenated along C."""
    BW, N, _ = qkv.shape
    h, hd = geo.num_heads, geo.head_dim
    q, k, v = qkv.reshape(-1, geo.n_windows, N, 3, h, hd).permute(
        3, 0, 1, 4, 2, 5)
    gate, mask = gate_and_mask(geo, qkv.device)
    out = window_attention_plain(
        q, k, v, rel_bias.float(),
        None if frag_bias is None else frag_bias.float(),
        gate if geo.use_frag else None, mask, scale)
    return out.transpose(2, 3).reshape(BW, N, h * hd).to(qkv.dtype)


def _linear(x, w, b):
    return F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))


def fused_swin_block_plain(x, params, rel_bias, frag_bias, geo, scale=None,
                           dp1=None, dp2=None):
    """Plain version of K1 (and of K4's forward, given the (BW,) DropPath
    multipliers ``dp1``/``dp2``): SwinBlock3D's XLA path on (BW, N, C)
    partitioned, rolled tokens.  ``params`` holds the block's weights under
    the JAX kernel's keys (norm1_scale, qkv_w, ...), each weight in
    nn.Linear's (out, in) layout.  Each branch is rounded to x's dtype,
    scaled by its multiplier and rounded again, as the kernels do."""
    scale = geo.head_dim ** -0.5 if scale is None else scale
    y = layer_norm(x, params["norm1_scale"], params["norm1_bias"])
    qkv = _linear(y, params["qkv_w"], params["qkv_b"])
    att = flash_window_attention_packed_plain(qkv, rel_bias, frag_bias, geo,
                                              scale)
    x1 = x + _branch(_linear(att, params["proj_w"], params["proj_b"]), dp1)
    y2 = layer_norm(x1, params["norm2_scale"], params["norm2_bias"])
    hmid = F.gelu(_linear(y2, params["fc1_w"], params["fc1_b"]))
    return x1 + _branch(_linear(hmid, params["fc2_w"], params["fc2_b"]), dp2)


def _branch(y, dp):
    """A residual branch times its per-window DropPath multiplier."""
    if dp is None:
        return y
    return (y.float() * dp.float()[:, None, None]).to(y.dtype)


def attention_nobias_heads_plain(q, k, v, scale: float):
    """Plain version of K7: q (X, h, N, hd), k/v (X, h, M, hd) ->
    (X, h, N, hd) in q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = (s * scale).softmax(dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def attention_nobias_plain(q, k, v, num_heads: int, scale: float):
    """Plain version of K2: CrossAttention's einsum path (nn/cdm.py)
    with an explicit scale.  q (X, N, C), k/v (X, M, C) -> (X, N, C)."""
    X, N, C = q.shape
    hd = C // num_heads

    def heads(t):
        return t.reshape(X, -1, num_heads, hd).transpose(1, 2)

    out = attention_nobias_heads_plain(heads(q), heads(k), heads(v), scale)
    return out.transpose(1, 2).reshape(X, N, C)


# ---------------------------------------------------------------------------
# CUDA wrappers


def _check_cuda(name: str, device, **tensors):
    for key, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_BLOCK_KEYS = ("norm1_scale", "norm1_bias", "qkv_w", "qkv_b", "proj_w",
               "proj_b", "norm2_scale", "norm2_bias", "fc1_w", "fc1_b",
               "fc2_w", "fc2_b")


def check_planes(name, rel_bias, frag_bias, geo):
    """The (h, N, N) bias planes of a window kernel: frag exactly when
    ``geo.use_frag``, float32 on CUDA."""
    if (frag_bias is not None) != geo.use_frag:
        raise ValueError(f"{name}: frag_bias must be given exactly when "
                         "geo.use_frag")
    shape = (geo.num_heads, geo.n_tokens, geo.n_tokens)
    for t in (rel_bias, frag_bias):
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: bias planes must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device.type == "cuda" and t.dtype != torch.float32:
            raise TypeError(f"{name}: bias planes must be float32")


def check_block_args(name, x, params, rel_bias, frag_bias, geo):
    """Shapes, dtypes and layout that the block kernels (K1, K4) take on
    CUDA; raises on anything else."""
    BW, N, C = x.shape
    hd = geo.head_dim
    hidden = params["fc1_w"].shape[0]
    if x.dtype != torch.bfloat16 or any(
        params[k].dtype != torch.bfloat16 for k in _BLOCK_KEYS
    ):
        raise TypeError(f"{name}: x and the block weights must be bfloat16 "
                        "on CUDA")
    check_planes(name, rel_bias, frag_bias, geo)
    if hd not in (32, 64) or C % 8 or hidden % 8:
        raise ValueError(f"{name}: unsupported C={C}, head_dim={hd}, "
                         f"hidden={hidden}")
    expect = {"qkv_w": (3 * C, C), "proj_w": (C, C), "fc1_w": (hidden, C),
              "fc2_w": (C, hidden)}
    for k, shape in expect.items():
        if tuple(params[k].shape) != shape:
            raise ValueError(f"{name}: {k} is {tuple(params[k].shape)}, "
                             f"expected {shape}")
    _check_cuda(name, x.device, x=x, rel_bias=rel_bias, frag_bias=frag_bias,
                **{k: params[k] for k in _BLOCK_KEYS})


def _geometry_args(geo):
    ints = ctypes.c_int * 3
    return (ints(*geo.dims), ints(*geo.window), ints(*geo.shift),
            ints(*geo.fragments))


def _refuse_grad(name, tensors, hint):
    """The eval kernels launch through ctypes and have no backward."""
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    ):
        raise RuntimeError(f"{name} is an eval kernel and has no backward: "
                           f"run it under torch.no_grad(), or {hint}")


def block_forward_cuda(x, params, rel_bias, frag_bias, geo, scale,
                       dp1=None, dp2=None, keep=False):
    """The block's forward as this repository's CUDA kernels (K1, and K4
    with the DropPath multipliers ``dp1``/``dp2`` of shape (BW,) f32).
    With ``keep`` it returns the intermediates K4's backward needs: y1,
    qkv, att, the attention's row log-sum-exp, x1, y2, the fc1
    pre-activation and its GELU.  Arguments are checked by the caller."""
    BW, N, C = x.shape
    h = geo.num_heads
    dev = x.device
    hidden = params["fc1_w"].shape[0]
    lib = build.load("swin_block")
    glib = build.load("gemm")
    stream = _stream(dev)
    sms = gemm_ops.sm_count(dev.index)
    M = BW * N
    p = params

    def gemm(a, w, b, res, n, k, gelu, dp=None, pre=None):
        out = torch.empty((M, n), dtype=torch.bfloat16, device=dev)
        gemm_ops.launch_forward(glib, stream, sms, _ptr(a), _ptr(w), _ptr(b),
                                _ptr(res), _ptr(out), M, n, k, gelu,
                                _ptr(dp), N, _ptr(pre))
        return out

    def norm(a, g, b):
        out = torch.empty_like(a)
        build.check(lib.kvq_layernorm(
            _ptr(a), _ptr(g), _ptr(b), _ptr(out), M, C, LN_EPS, stream,
        ), "swin block layernorm")
        return out

    with torch.cuda.device(dev):
        y1 = norm(x, p["norm1_scale"], p["norm1_bias"])
        qkv = gemm(y1, p["qkv_w"], p["qkv_b"], None, 3 * C, C, False)
        att = torch.empty((M, C), dtype=torch.bfloat16, device=dev)
        lse = (torch.empty((BW, h, N), dtype=torch.float32, device=dev)
               if keep else None)
        build.check(lib.kvq_window_attention(
            _ptr(qkv), _ptr(rel_bias), _ptr(frag_bias), _ptr(att), BW, N, C,
            h, *_geometry_args(geo), scale, _ptr(lse), stream,
        ), "swin block window attention")
        x1 = gemm(att, p["proj_w"], p["proj_b"], x, C, C, False, dp1)
        y2 = norm(x1, p["norm2_scale"], p["norm2_bias"])
        pre = (torch.empty((M, hidden), dtype=torch.bfloat16, device=dev)
               if keep else None)
        hmid = gemm(y2, p["fc1_w"], p["fc1_b"], None, hidden, C, True,
                    pre=pre)
        if keep:
            return dict(y1=y1, qkv=qkv, att=att, lse=lse, x1=x1, y2=y2,
                        pre=pre, hmid=hmid)
        out = gemm(hmid, p["fc2_w"], p["fc2_b"], x1, C, hidden, False, dp2)
    return out.view(BW, N, C)


def fused_swin_block(x, params, rel_bias, frag_bias, geo: WindowGeometry,
                     scale=None):
    """K1, the eval block: no gradient flows through it (training takes K4,
    :func:`~kvq_tpu_torch.ops.train_attention.train_swin_block`).
    x: (BW, N, C) partitioned+rolled tokens; params as for
    :func:`fused_swin_block_plain`; rel/frag: (h, N, N) float32 planes
    (frag None when the stage has no fragment bias).  Returns the block
    output (BW, N, C)."""
    BW, N, C = x.shape
    h, hd = geo.num_heads, geo.head_dim
    if h * hd != C or N != geo.n_tokens or BW != geo.batch * geo.n_windows:
        raise ValueError(f"fused_swin_block: x {tuple(x.shape)} does not "
                         f"match {geo}")
    if (frag_bias is not None) != geo.use_frag:
        raise ValueError("fused_swin_block: frag_bias must be given exactly "
                         "when geo.use_frag")
    _refuse_grad("fused_swin_block", (x, rel_bias, frag_bias,
                                      *params.values()),
                 "train through train_swin_block")
    scale = hd ** -0.5 if scale is None else float(scale)
    if x.device.type == "cpu":
        return fused_swin_block_plain(x, params, rel_bias, frag_bias, geo,
                                      scale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_swin_block: unsupported device {x.device}")
    check_block_args("fused_swin_block", x, params, rel_bias, frag_bias, geo)
    out = block_forward_cuda(x, params, rel_bias, frag_bias, geo, scale)
    fused_swin_block.launches += 1
    return out


fused_swin_block.launches = 0


def _rows(name, key, t, X, L, C):
    if t.dim() != 3 or tuple(t.shape) != (X, L, C):
        raise ValueError(f"{name}: {key} is {tuple(t.shape)}, expected "
                         f"{(X, L, C)}")
    if t.stride(2) != 1 or t.stride(0) != L * t.stride(1) or t.stride(1) % 8:
        raise ValueError(f"{name}: {key} needs unit channel stride, a row "
                         "stride that is a multiple of 8 and packed rows")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: {key} must be 16-byte aligned")
    return t.stride(1)


def flash_attention_nobias_cl(q, k, v, num_heads: int, scale=None):
    """K2.  q (X, N, C), k/v (X, M, C) -> (X, N, C); heads split along C.
    q, k and v may be channel slices of one fused projection (row stride
    larger than C)."""
    X, N, C = q.shape
    M = k.shape[1]
    hd = C // num_heads
    if hd * num_heads != C:
        raise ValueError(f"flash_attention_nobias_cl: C={C} is not divisible "
                         f"by {num_heads} heads")
    scale = hd ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return attention_nobias_plain(q, k, v, num_heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_nobias_cl: unsupported device "
                         f"{q.device}")
    name = "flash_attention_nobias_cl"
    for key, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {key} must be bfloat16 on CUDA")
        if t.device != q.device:
            raise ValueError(f"{name}: {key} is on {t.device}")
    if hd not in (32, 64):
        raise ValueError(f"{name}: unsupported head_dim {hd}")
    ldq = _rows(name, "q", q, X, N, C)
    ldk = _rows(name, "k", k, X, M, C)
    ldv = _rows(name, "v", v, X, M, C)
    lib = build.load("nobias_attention")
    out = torch.empty((X, N, C), dtype=torch.bfloat16, device=q.device)
    with torch.cuda.device(q.device):
        build.check(lib.kvq_attention_nobias(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), X, N, M, C, num_heads,
            ldq, ldk, ldv, scale, _stream(q.device),
        ), name)
    flash_attention_nobias_cl.launches += 1
    return out


flash_attention_nobias_cl.launches = 0

_MAX_GRID_Z = 65535  # the kernels put (window or batch entry) on grid z


def _check_window_geometry(name, geo):
    """What the window kernels rebuild the gate and seams from: the padded
    token volume (a whole number of windows on each axis), shifts inside
    the window, fragment ids that fit their 8 bits."""
    if any(d % w for d, w in zip(geo.dims, geo.window)):
        raise ValueError(f"{name}: dims {geo.dims} must be the padded token "
                         f"volume, a multiple of the window {geo.window}")
    if any(not 0 <= s < w for s, w in zip(geo.shift, geo.window)):
        raise ValueError(f"{name}: shift {geo.shift} outside the window")
    if any(not 1 <= f <= 255 for f in geo.fragments):
        raise ValueError(f"{name}: fragments {geo.fragments} outside [1, 255]")


def _check_eval_attention(name, ref, tensors, hd, batch):
    """The CUDA-side checks shared by K3, K6 and K7: bf16 inputs on ref's
    device, a head dim the template takes, a batch that fits the grid."""
    for key, t in tensors.items():
        if t.device != ref.device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{ref.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: {key} must be bfloat16 on CUDA")
    if hd not in (32, 64):
        raise ValueError(f"{name}: unsupported head_dim {hd}")
    if batch > _MAX_GRID_Z:
        raise ValueError(f"{name}: {batch} windows or batch entries exceed "
                         f"the grid's {_MAX_GRID_Z}")


def _head_major_strides(name, **tensors):
    """(batch, head, row) strides of each (X, h, L, hd) tensor, as the
    kernel reads them: rows of unit stride, 16-byte aligned, and strides
    that keep every row 16-byte aligned."""
    out = []
    for key, t in tensors.items():
        if t.stride(3) != 1 or t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} needs 16-byte aligned rows of "
                             "unit stride")
        strides = [s if n > 1 else 0 for s, n in zip(t.stride()[:3],
                                                      t.shape[:3])]
        if any(s % 8 for s in strides):
            raise ValueError(f"{name}: {key} has strides {t.stride()}; the "
                             "batch, head and row strides must be multiples "
                             "of 8")
        out += strides
    return (ctypes.c_longlong * len(out))(*out)


def flash_window_attention_packed(qkv, rel_bias, frag_bias,
                                  geo: WindowGeometry, scale=None):
    """K3, the eval window attention of a block that K1 declines.  qkv:
    (BW, N, 3C), the qkv product of partitioned, rolled, padded tokens;
    rel/frag: (h, N, N) float32 planes (frag exactly when ``geo.use_frag``);
    ``geo.dims`` the padded token volume.  Returns (BW, N, C), heads
    concatenated along C."""
    name = "flash_window_attention_packed"
    h, hd, N = geo.num_heads, geo.head_dim, geo.n_tokens
    BW = geo.batch * geo.n_windows
    if qkv.dim() != 3 or tuple(qkv.shape) != (BW, N, 3 * h * hd):
        raise ValueError(f"{name}: qkv {tuple(qkv.shape)} does not match "
                         f"{geo}")
    _check_window_geometry(name, geo)
    check_planes(name, rel_bias, frag_bias, geo)
    _refuse_grad(name, (qkv, rel_bias, frag_bias),
                 "train through window_attention_train")
    scale = hd ** -0.5 if scale is None else float(scale)
    if qkv.device.type == "cpu":
        return flash_window_attention_packed_plain(qkv, rel_bias, frag_bias,
                                                   geo, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {qkv.device}")
    _check_eval_attention(name, qkv, {"qkv": qkv}, hd, BW)
    _check_cuda(name, qkv.device, qkv=qkv, rel_bias=rel_bias,
                frag_bias=frag_bias)
    dev = qkv.device
    lib = build.load("swin_block")  # K1's attention entry, without the lse
    out = torch.empty((BW, N, h * hd), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        build.check(lib.kvq_window_attention(
            _ptr(qkv), _ptr(rel_bias), _ptr(frag_bias), _ptr(out), BW, N,
            h * hd, h, *_geometry_args(geo), scale, None, _stream(dev),
        ), name)
    flash_window_attention_packed.launches += 1
    return out


flash_window_attention_packed.launches = 0


def flash_window_attention(q, k, v, rel_bias, frag_bias, geo: WindowGeometry,
                           scale=None):
    """K6, K3 on head-major tensors: q/k/v (BW, h, N, hd), any strides that
    keep each row of hd contiguous; rel/frag and ``geo`` as for K3.
    Returns (BW, h, N, hd)."""
    name = "flash_window_attention"
    shape = (geo.batch * geo.n_windows, geo.num_heads, geo.n_tokens,
             geo.head_dim)
    for key, t in (("q", q), ("k", k), ("v", v)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} {tuple(t.shape)} does not match "
                             f"{geo}")
    _check_window_geometry(name, geo)
    check_planes(name, rel_bias, frag_bias, geo)
    _refuse_grad(name, (q, k, v, rel_bias, frag_bias),
                 "train through window_attention_train")
    BW, h, N, hd = shape
    scale = hd ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return flash_window_attention_plain(q, k, v, rel_bias, frag_bias,
                                            geo, scale)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    _check_eval_attention(name, q, {"q": q, "k": k, "v": v}, hd, BW)
    strides = _head_major_strides(name, q=q, k=k, v=v)
    _check_cuda(name, q.device, rel_bias=rel_bias, frag_bias=frag_bias)
    dev = q.device
    lib = build.load("eval_attention")
    out = torch.empty(shape, dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        build.check(lib.kvq_window_attention_heads(
            _ptr(q), _ptr(k), _ptr(v), _ptr(rel_bias), _ptr(frag_bias),
            _ptr(out), BW, N, h, hd, strides, *_geometry_args(geo), scale,
            _stream(dev),
        ), name)
    flash_window_attention.launches += 1
    return out


flash_window_attention.launches = 0


def flash_attention_nobias(q, k, v, scale=None):
    """K7, K2 on head-major tensors: q (X, h, N, hd), k/v (X, h, M, hd),
    any strides that keep each row of hd contiguous.  Returns
    (X, h, N, hd)."""
    name = "flash_attention_nobias"
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: q and k must be (X, h, L, hd)")
    X, h, N, hd = q.shape
    M = k.shape[2]
    if tuple(k.shape) != (X, h, M, hd) or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)} "
                         f"and v {tuple(v.shape)} do not agree")
    _refuse_grad(name, (q, k, v), "train through the plain composition")
    scale = hd ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        return attention_nobias_heads_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    _check_eval_attention(name, q, {"q": q, "k": k, "v": v}, hd, X)
    strides = _head_major_strides(name, q=q, k=k, v=v)
    dev = q.device
    lib = build.load("eval_attention")
    out = torch.empty((X, h, N, hd), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        build.check(lib.kvq_attention_nobias_heads(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), X, N, M, h, hd, strides,
            scale, _stream(dev),
        ), name)
    flash_attention_nobias.launches += 1
    return out


flash_attention_nobias.launches = 0
