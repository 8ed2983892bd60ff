"""Precision of the reference's products.

The reference runs in float32 with TF32 off (:func:`exact_float32`).
The control of the correctness check is the same reference one step of
precision below what the configurations state (bfloat16), as FP8
training runs it (:class:`Float8Products`): every product (linear layers,
matmuls, einsums, convolutions) takes its two operands rounded to float8
e4m3, each scaled by its own largest magnitude as an FP8 GEMM scales
them, and accumulates in float32; in the backward the gradient that
reaches each product is rounded to float8 e5m2 the same way, so the
backward's products take float8 operands too.  The elementwise work
stays float32, as it does around FP8 GEMMs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def exact_float32() -> None:
    """TF32 off for cuBLAS and cuDNN: float32 products stay float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` under one per-tensor scale
    that maps its largest magnitude to ``top``, in float32."""
    scale = top / x.abs().amax().float().clamp_min(1e-30)
    return (x.float() * scale).to(dtype).float() / scale


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3, in float32; the gradient passes
    through the rounding unchanged."""
    if not x.is_floating_point():
        return x
    xf = x.float()
    with torch.no_grad():
        q = _round(xf, torch.float8_e4m3fn, E4M3_MAX)
    return xf + (q - xf).detach()


class _GradE5M2(torch.autograd.Function):
    """Identity forward; the backward rounds the gradient to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def _grad_e5m2(out):
    if isinstance(out, torch.Tensor) and out.requires_grad:
        return _GradE5M2.apply(out)
    return out


_PRODUCTS = {F.linear: (0, 1), torch.matmul: (0, 1), torch.Tensor.matmul:
             (0, 1), torch.Tensor.__matmul__: (0, 1), torch.bmm: (0, 1),
             F.conv1d: (0, 1), F.conv2d: (0, 1), F.conv3d: (0, 1)}


class Float8Products(TorchFunctionMode):
    """Inside this mode each product rounds its operands to e4m3."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            args = list(args)
            for i in _PRODUCTS[func]:
                if i < len(args) and isinstance(args[i], torch.Tensor):
                    args[i] = to_e4m3(args[i])
        elif func is torch.einsum:
            eq, *ops = args
            args = [eq] + [to_e4m3(o) if isinstance(o, torch.Tensor) else o
                           for o in ops]
        else:
            return func(*args, **kwargs)
        return _grad_e5m2(func(*args, **kwargs))
