#!/usr/bin/env python3
"""Times the port's attention kernels on one NVIDIA GPU, for one or more
checkouts of the repo in turn, so that two versions of the shared flash
forward body (``kvq_tpu_torch/ops/csrc/flash_attention.cuh``) or of the
window-attention backward (``ops/csrc/train_attention.cu``) compare on one
card in one run.

    python3 tools/torch_attention_timing.py --root OLD --root NEW \
        [--kernels "K5 bwd,K4 bwd"] [--out attention_timing.json]
    python3 tools/torch_attention_timing.py --root OLD --root NEW \
        --kernels gemm

Every kernel that launches the body is timed at chip_smoke.py's shapes:
K3 at the four padded stage geometries of swin_tiny_grpb and the two of
swin_tiny_grpb_m, unshifted and shifted; K6 at stage 0's; K2 and K7 at the
nine CDM shapes; K5's forward at train stage 3; K1 at KSVQE's four stage
geometries; K4's forward at train stages 0-2; K5's backward
(``window_attention_train_bwd``) at the four train stages' shapes and K4's
(``train_swin_block_bwd``, the packed-qkv layout) at stages 0-2, unshifted
and shifted: from the intermediates its forward kept, or, in a checkout
from before K4's forward kept them, with its recompute of the forward.  ``--kernels`` keeps the cases of the kernels it names.  Each
case is first held against its plain version (chip_smoke's tolerances;
every gradient of a backward) and fails the run past them.  Each root runs in a process of its own (its kernels build into its
own ``ops/_build``), in the order given and then reversed (A B B A), and a
case's time is the mean of a root's runs.  A case's time is taken twice: CUDA events around 20 calls (the time
per call as a caller sees it) and the profiler's kernel time of 10 calls
(device time alone, which differs where the host's dispatch of a call
outlasts its kernels).  A backward's device time is also split by kernel:
the DQ, DK/DV and bias passes (the PASS argument of
``attention_bwd_kernel``), the D row sums, and the rest (K4's products and
LayerNorms); and it is timed beside SDPA's backward through autograd on
the same q, k, v with the blended bias and seam mask as a float mask (the
library yardstick; for K4 at its attention's shapes).  ``--kernels gemm``
times the Swin block's products instead (``ops/gemm.py``): every product of
K1 at the four KSVQE eval stages and of K4 at train stages 0-2, forward, dX
and dW (chip_smoke.py's ``gemm_cases``), each checked against an f32
torch.matmul and timed beside one cuBLAS call of the same product
(``F.linear`` or ``torch.matmul`` in bf16) and its bound; then the sums per
KSVQE forward and per train step.  A checkout from before ``ops/gemm.py``
is driven through its C entries with their earlier signatures.  Prints one
line per case and version and writes every time to ``--out``.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cases(smoke):
    """(kernel, name, run, plain, tol, nbytes, flops, setup) for each case;
    ``setup`` builds the inputs on the card and returns the arguments."""
    out = []
    for model, stages, window, idx in (
            ("swin_tiny_grpb", smoke.SWIN_STAGES, (8, 7, 7), range(4)),
            ("swin_tiny_grpb_m", smoke.GRPB_M_STAGES, smoke.GRPB_M_WINDOW,
             (2, 3))):
        for stage in idx:
            for shifted in (False, True):
                out.append(("K3", f"{model} stage{stage} shift={int(shifted)}",
                            (model, stages, window, stage, shifted)))
    for shifted in (False, True):
        out.append(("K6", f"stage0 shift={int(shifted)}",
                    ("swin_tiny_grpb", smoke.SWIN_STAGES, (8, 7, 7), 0,
                     shifted)))
    for m in range(9):
        out.append(("K2", f"cdm case {m}", m))
        out.append(("K7", f"cdm case {m}", m))
    for shift in ((0, 0, 0), (4, 0, 0)):
        out.append(("K5 fwd", f"stage3 shift={shift}", shift))
    for stage in range(4):
        for shifted in (False, True):
            out.append(("K1", f"KSVQE stage{stage} shift={int(shifted)}",
                        (stage, shifted)))
    for stage in range(3):
        for shifted in (False, True):
            out.append(("K4 fwd", f"train stage{stage} shift={int(shifted)}",
                        (stage, shifted)))
    for stage in range(4):
        for shifted in (False, True):
            out.append(("K5 bwd", f"train stage{stage} shift={int(shifted)}",
                        (stage, shifted)))
    for stage in range(3):
        for shifted in (False, True):
            out.append(("K4 bwd", f"train stage{stage} shift={int(shifted)}",
                        (stage, shifted)))
    for case in smoke.gemm_cases():
        kernel, stage, prod, layout, M, N, K, _, _ = case
        out.append(("gemm", f"{kernel} stage{stage} {prod} ({layout} M={M} "
                    f"N={N} K={K})", case))
    return out


def _legacy_gemm_fns():
    """linear, input_grad and weight_grad for a checkout from before
    ops/gemm.py: its kvq_gemm and kvq_gemm_bwd, in the swin_block library,
    with their earlier signatures and dW split."""
    import torch

    from kvq_tpu_torch.ops import build

    lib = build.load("swin_block")
    bf, f32 = torch.bfloat16, torch.float32

    def ptr(t):
        return None if t is None else t.data_ptr()

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def linear(a, w, bias, res=None, gelu=False, dp=None, dp_rows=1,
               keep_pre=False):
        (M, K), N = a.shape, w.shape[0]
        out = torch.empty((M, N), dtype=bf, device=a.device)
        pre = torch.empty_like(out) if keep_pre else None
        build.check(lib.kvq_gemm(ptr(a), ptr(w), ptr(bias), ptr(res),
                                 ptr(out), M, N, K, int(gelu), ptr(dp),
                                 dp_rows, ptr(pre), stream()), "gemm")
        return out, pre

    def input_grad(dy, w, epi, aux=None):
        (M, K), N = dy.shape, w.shape[1]
        out = torch.empty((M, N), dtype=f32 if epi == 1 else bf,
                          device=dy.device)
        build.check(lib.kvq_gemm_bwd(
            ptr(dy), ptr(w), ptr(aux), None if epi == 1 else ptr(out),
            ptr(out) if epi == 1 else None, M, N, K, 0, epi, 1, stream()),
            "gemm dX")
        return out

    def weight_grad(dy, x):
        (R, n_out), n_in = dy.shape, x.shape[1]
        out = torch.zeros((n_out, n_in), dtype=f32, device=dy.device)
        tiles = -(-n_out // 128) * -(-n_in // 128)
        splits = max(1, min(-(-R // 512), 528 // tiles))
        build.check(lib.kvq_gemm_bwd(ptr(dy), ptr(x), None, None, ptr(out),
                                     n_out, n_in, R, 1, 0, splits, stream()),
                    "gemm dW")
        return out

    return linear, input_grad, weight_grad


def _gemm_row(smoke, case, gen, fns):
    """One product of :func:`chip_smoke.gemm_cases`: checked against its f32
    reference, timed (CUDA events and device time) beside cuBLAS."""
    import torch

    run, reference, cublas, nbytes, flops, tol = smoke.gemm_case(
        case, gen, *fns)
    got, want = run(), reference()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    lim = tol * max(1.0, want.float().abs().max().item())
    del got, want
    if not (math.isfinite(err) and err <= lim):
        raise SystemExit(f"gemm {case}: max|d| {err} > tol {lim}")
    b, by = smoke.bound_ms(nbytes, flops)
    return {"ms": smoke.cuda_ms(run, 20), "device_ms": device_ms(run)[0],
            "parts": {}, "err": err, "lib_ms": smoke.cuda_ms(cublas, 20),
            "lib_device_ms": device_ms(cublas)[0], "lib_name": "cublas",
            "calls": case[-1], "bound_ms": b, "bound_by": by}


def _part(name: str) -> str:
    """The part of a backward a kernel name belongs to."""
    m = re.search(r"attention_bwd_kernel<\d+, (\d)", name)
    if m:
        return ("dq", "dkdv", "bias")[int(m.group(1))]
    return "dsum" if "attn_dsum_kernel" in name else "other"


def device_ms(fn, calls: int = 10) -> tuple[float, dict]:
    """Device time of one call of ``fn``: the profiler's kernel time over
    ``calls`` calls, which leaves out the host's share that CUDA events see
    when a call's kernels are shorter than its dispatch; and that time by
    ``_part``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    parts: dict = {}
    for e in prof.key_averages():
        if (str(getattr(e, "device_type", "")) != "DeviceType.CUDA"
                or getattr(e, "is_user_annotation", False)):
            continue  # host events; a span's range is no kernel
        part = _part(e.key)
        parts[part] = (parts.get(part, 0.0)
                       + getattr(e, "self_device_time_total", 0.0) / 1e3 / calls)
    return sum(parts.values()), parts


def sdpa_bwd(smoke, q, k, v, mask, dout, scale):
    """SDPA's backward through autograd into q, k, v and the float mask:
    (CUDA-event ms, device ms) per call."""
    import torch
    import torch.nn.functional as F

    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    m = mask.detach().clone().requires_grad_()
    y = F.scaled_dot_product_attention(*leaves, attn_mask=m, scale=scale)

    def fn():
        return torch.autograd.grad(y, leaves + [m], dout, retain_graph=True)

    return smoke.cuda_ms(fn, 20), device_ms(fn)[0]


def grad_err(name, got, want, tol):
    """max|got - want| of a gradient; fails past tol x its largest magnitude."""
    err = (got.float() - want.float()).abs().max().item()
    lim = tol * max(want.float().abs().max().item(), 1e-6)
    if not (math.isfinite(err) and err <= lim):
        raise SystemExit(f"{name}: max|d| {err} > tol {lim}")
    return err


def _keeps(TA) -> bool:
    """Whether K4's forward can keep what its backward reads (a checkout
    from before that recomputes the forward in the backward)."""
    import inspect

    return "keep" in inspect.signature(TA.train_swin_block_fwd).parameters


def _backward_case(smoke, kernel, spec, gen):
    """A backward case at chip_smoke's train shapes (B=4, T=32): (kernel
    gradients, plain gradients, fn, args, bytes, FLOPs, SDPA backward)."""
    import torch

    from kvq_tpu_torch.nn.swin import expand_bias_planes, get_window_size
    from kvq_tpu_torch.ops import train_attention as TA
    from kvq_tpu_torch.ops import window_attention as WA

    bf = torch.bfloat16
    stage, shifted = spec
    B = smoke.TRAIN_B
    if kernel == "K5 bwd":
        dims, C, h, use_frag = smoke.TRAIN_STAGES[stage]
        win, sh = get_window_size(dims, (8, 7, 7),
                                  (4, 3, 3) if shifted else (0, 0, 0))
        geo = WA.WindowGeometry(batch=B, dims=dims, window=win, shift=sh,
                                fragments=(1, 7, 7), num_heads=h,
                                head_dim=C // h, use_frag=use_frag)
        N, hd, BW = geo.n_tokens, geo.head_dim, B * geo.n_windows
        q, k, v, dout = (torch.randn(BW, h, N, hd, generator=gen,
                                     device="cuda").to(bf) for _ in range(4))
        tables = torch.randn(2, 15 * 13 * 13, h, generator=gen,
                             device="cuda") * 0.5
        rel = expand_bias_planes(tables[0], (8, 7, 7), N)
        frag = (expand_bias_planes(tables[1], (8, 7, 7), N) if use_frag
                else None)
        scale = hd ** -0.5
        out, lse = TA.window_attention_train_fwd(q, k, v, rel, frag, geo,
                                                 scale)
        args = (q, k, v, rel, frag, geo, scale, out, lse, dout)
        fn = TA.window_attention_train_bwd
        got = fn(*args)
        want = TA.window_attention_train_bwd_plain(q, k, v, rel, frag, geo,
                                                   scale, out, dout)
        planes = (1 + int(use_frag)) * h * N * N * 4
        nbytes = 8 * BW * h * N * hd * 2 + 2 * planes + BW * h * N * 4
        flops = 2.5 * 4 * BW * h * N * N * hd
    else:  # K4's backward, the packed-qkv layout
        (x, params, rel, frag, geo), fflops, _ = smoke.block_case(
            stage, shifted, gen, smoke.TRAIN_STAGES, B)
        BW, N, C = x.shape
        h, hd = geo.num_heads, geo.head_dim
        scale = hd ** -0.5
        dp1 = smoke._multipliers(B, geo.n_windows, gen)
        dp2 = smoke._multipliers(B, geo.n_windows, gen)
        dout = torch.randn(x.shape, generator=gen, device="cuda").to(bf)
        fargs = (x, params, rel, frag, geo, scale, dp1, dp2)
        if _keeps(TA):  # the backward reads what the forward kept
            _, kept = TA.train_swin_block_fwd(*fargs, keep=True)
            _, rkept = WA.fused_swin_block_plain(*fargs, keep=True)
            args, rargs = (*fargs, kept, dout), (*fargs, rkept, dout)
        else:  # a checkout whose backward recomputes the forward
            args = rargs = (*fargs, dout)
        fn = TA.train_swin_block_bwd
        dx, g, drel, dfrag = fn(*args)
        rdx, rg, rdrel, rdfrag = TA.train_swin_block_bwd_plain(*rargs)
        got = [dx, drel, dfrag] + [g[key].reshape(rg[key].shape) for key in g]
        want = [rdx, rdrel, rdfrag] + [rg[key] for key in g]
        planes = (1 + int(frag is not None)) * h * N * N * 4
        w = 12 * C * C
        nbytes = 3 * BW * N * C * 2 + w * 2 + w * 4 + 2 * planes + 2 * BW * 4
        flops = 2 * fflops  # the products backward, no forward
        q, k, v = (torch.randn(BW, h, N, hd, generator=gen, device="cuda")
                   .to(bf) for _ in range(3))
        dout = torch.randn(BW, h, N, hd, generator=gen, device="cuda").to(bf)
    mask = smoke.window_attn_mask(rel, frag, geo).repeat(B, 1, 1, 1)
    lib = sdpa_bwd(smoke, q, k, v, mask, dout, scale)
    torch.cuda.synchronize()
    return got, want, fn, args, nbytes, flops, lib


def run_one(root: str, out_path: str, kernels: str, match: str = "") -> None:
    """Time the cases of ``kernels`` (all when empty) whose names contain
    ``match`` with the package of ``root``; write a JSON list."""
    sys.path.insert(0, HERE)
    import chip_smoke as smoke  # this checkout's helpers and shapes

    # chip_smoke imported this checkout's package (its kernel names): drop
    # it, so that the imports below, and chip_smoke's own, load root's
    for name in [m for m in sys.modules if m.split(".")[0] == "kvq_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from kvq_tpu_torch.nn.swin import expand_bias_planes, get_window_size
    from kvq_tpu_torch.ops import build
    from kvq_tpu_torch.ops import train_attention as TA
    from kvq_tpu_torch.ops import window_attention as WA

    assert WA.__file__.startswith(os.path.abspath(root)), WA.__file__
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    cdm = smoke.attention_cases(gen)
    rows = []
    keep = {k.strip() for k in kernels.split(",") if k.strip()}
    if "gemm" in keep:
        try:
            from kvq_tpu_torch.ops import gemm as G
            gemm_fns = (G.linear, G.input_grad, G.weight_grad)
        except ImportError:
            gemm_fns = _legacy_gemm_fns()
    for kernel, name, spec in _cases(smoke):
        if (keep and kernel not in keep or not keep and kernel == "gemm"
                or match not in name):
            continue
        if kernel == "gemm":
            rows.append({"kernel": kernel, "case": name,
                         **_gemm_row(smoke, spec, gen, gemm_fns)})
            torch.cuda.empty_cache()
            continue
        lib = None  # (CUDA-event ms, device ms) of the library yardstick
        if kernel in ("K5 bwd", "K4 bwd"):
            got, want, fn, args, nbytes, flops, lib = _backward_case(
                smoke, kernel, spec, gen)
            err = max(grad_err(f"{kernel} {name} {i}", a, b, smoke.GRAD_TOL)
                      for i, (a, b) in enumerate(zip(got, want))
                      if b is not None)
            del got, want
        elif kernel in ("K3", "K6"):
            model, stages, window, stage, shifted = spec
            dims, C, h, use_frag = stages[stage]
            geo = smoke.padded_geometry(dims, C, h, use_frag, shifted, window)
            N, BW, hd = geo.n_tokens, geo.n_windows, geo.head_dim
            qkv = torch.randn(BW, N, 3 * C, generator=gen, device="cuda").to(bf)
            tables = torch.randn(2, math.prod(2 * w - 1 for w in window), h,
                                 generator=gen, device="cuda") * 0.5
            rel = expand_bias_planes(tables[0], window, N)
            frag = (expand_bias_planes(tables[1], window, N) if use_frag
                    else None)
            planes = (1 + use_frag) * h * N * N * 4
            flops = 4 * BW * h * N * N * hd
            if kernel == "K3":
                args = (qkv, rel, frag, geo, hd ** -0.5)
                fn, plain = (WA.flash_window_attention_packed,
                             WA.flash_window_attention_packed_plain)
                nbytes = BW * N * 4 * C * 2 + planes
            else:
                qh, kh, vh = (t.contiguous() for t in
                              qkv.view(BW, N, 3, h, hd).permute(2, 0, 3, 1, 4))
                args = (qh, kh, vh, rel, frag, geo, hd ** -0.5)
                fn, plain = (WA.flash_window_attention,
                             WA.flash_window_attention_plain)
                nbytes = 4 * BW * h * N * hd * 2 + planes
            tol = smoke.K2_TOL
        elif kernel in ("K2", "K7"):
            _, q, k, v, h, scale = cdm[spec]
            X, N, C = q.shape
            M = k.shape[1]
            if kernel == "K2":
                args = (q, k, v, h, scale)
                fn, plain = (WA.flash_attention_nobias_cl,
                             WA.attention_nobias_plain)
            else:
                args = tuple(t.reshape(X, -1, h, C // h).transpose(1, 2)
                             .contiguous() for t in (q, k, v)) + (scale,)
                fn, plain = (WA.flash_attention_nobias,
                             WA.attention_nobias_heads_plain)
            nbytes, flops = (2 * N + 2 * M) * X * C * 2, 4 * X * N * M * C
            tol = smoke.K2_TOL
        elif kernel == "K5 fwd":
            dims, C, h, use_frag = smoke.TRAIN_STAGES[3]
            win, sh = get_window_size(dims, (8, 7, 7), spec)
            geo = WA.WindowGeometry(batch=smoke.TRAIN_B, dims=dims, window=win,
                                    shift=sh, fragments=(1, 7, 7), num_heads=h,
                                    head_dim=C // h, use_frag=use_frag)
            N, hd = geo.n_tokens, geo.head_dim
            BW = smoke.TRAIN_B * geo.n_windows
            q, k, v = (torch.randn(BW, h, N, hd, generator=gen, device="cuda")
                       .to(bf) for _ in range(3))
            rel = expand_bias_planes(torch.randn(
                15 * 13 * 13, h, generator=gen, device="cuda") * 0.5,
                (8, 7, 7), N)
            args = (q, k, v, rel, None, geo, hd ** -0.5)
            fn = lambda *a: TA.window_attention_train_fwd(*a)[0]  # noqa: E731
            plain = TA.window_attention_train_plain
            nbytes = 4 * BW * h * N * hd * 2 + h * N * N * 4 + BW * h * N * 4
            flops = 4 * BW * h * N * N * hd
            tol = smoke.K2_TOL
        elif kernel == "K1":
            stage, shifted = spec
            args, flops, nbytes = smoke.block_case(stage, shifted, gen)
            fn, plain = WA.fused_swin_block, WA.fused_swin_block_plain
            tol = smoke.K1_TOL
        else:  # K4's forward
            stage, shifted = spec
            (x, params, rel, frag, geo), flops, _ = smoke.block_case(
                stage, shifted, gen, smoke.TRAIN_STAGES, smoke.TRAIN_B)
            nW = geo.n_windows
            dp1 = smoke._multipliers(smoke.TRAIN_B, nW, gen)
            dp2 = smoke._multipliers(smoke.TRAIN_B, nW, gen)
            args = (x, params, rel, frag, geo, geo.head_dim ** -0.5, dp1, dp2)
            fn = TA.train_swin_block_fwd
            if _keeps(TA):  # time the forward that training runs
                fn = lambda *a: TA.train_swin_block_fwd(  # noqa: E731
                    *a, keep=True)[0]
            plain = WA.fused_swin_block_plain
            BW, N, C = x.shape
            nbytes = (2 * BW * N * C * 2 + 24 * C * C
                      + (1 + int(frag is not None)) * geo.num_heads * N * N * 4)
            tol = smoke.K1_TOL
        if kernel not in ("K5 bwd", "K4 bwd"):
            got, want = fn(*args), plain(*args)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            lim = tol * max(1.0, want.float().abs().max().item())
            if not (math.isfinite(err) and err <= lim):
                raise SystemExit(f"{kernel} {name}: max|d| {err} > tol {lim}")
            del got, want
        ms = smoke.cuda_ms(lambda: fn(*args), 20)
        dms, parts = device_ms(lambda: fn(*args))
        b, by = smoke.bound_ms(nbytes, flops)
        rows.append({"kernel": kernel, "case": name, "ms": ms,
                     "device_ms": dms, "parts": parts, "err": err,
                     "lib_ms": lib and lib[0], "lib_device_ms": lib and lib[1],
                     "bound_ms": b, "bound_by": by})
        del args
        torch.cuda.empty_cache()
    with open(out_path, "w") as f:
        json.dump(rows, f)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", default=[],
                    help="a checkout of the repo (default: this one)")
    ap.add_argument("--out", default="attention_timing.json")
    ap.add_argument("--kernels", default="",
                    help='comma-separated kernels to time, e.g. "K5 bwd,K4 '
                         'bwd", or "gemm" for the block\'s products (default: '
                         'every attention kernel)')
    ap.add_argument("--match", default="",
                    help="time only the cases whose names contain this")
    ap.add_argument("--one", nargs=2, metavar=("ROOT", "OUT"),
                    help=argparse.SUPPRESS)  # a single run, in a subprocess
    a = ap.parse_args()
    if a.one:
        run_one(*a.one, a.kernels, a.match)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available", flush=True)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    labels = a.root or [HERE]
    order = labels + labels[::-1]
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    times: dict = {}
    for i, label in enumerate(order):
        tmp = f"{a.out}.run{i}"
        rc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", label, tmp,
             "--kernels", a.kernels, "--match", a.match]).returncode
        if rc != 0:
            print(f"FAIL: the run of {label} exited {rc}", flush=True)
            return 1
        with open(tmp) as f:
            for row in json.load(f):
                key = (row["kernel"], row["case"])
                times.setdefault(key, {"bound_ms": row["bound_ms"],
                                       "bound_by": row["bound_by"]})
                times[key].setdefault(label, []).append(row["ms"])
                times[key].setdefault(f"{label} device", []).append(
                    row["device_ms"])
                times[key].setdefault(f"{label} max|d|", []).append(row["err"])
                times[key].setdefault(f"{label} parts", []).append(
                    row["parts"])
                if row["lib_ms"] is not None:
                    lib = row.get("lib_name", "sdpa bwd")
                    times[key]["lib"] = lib
                    times[key].setdefault(f"{label} {lib}", []).append(
                        row["lib_ms"])
                    times[key].setdefault(f"{label} {lib} device", []
                                          ).append(row["lib_device_ms"])
                if "calls" in row:
                    times[key]["calls"] = row["calls"]
        os.remove(tmp)
    def mean(xs):
        return sum(xs) / len(xs)

    def col(t, lab):
        c = (f"{lab}: {mean(t[lab]):.4f} ms "
             f"({', '.join(f'{x:.4f}' for x in t[lab])}), device "
             f"{mean(t[lab + ' device']):.4f} ms")
        runs = t[lab + " parts"]
        names = sorted({n for r in runs for n in r})
        if "dq" in names:  # a backward: its device time by part
            c += " [" + ", ".join(
                f"{n} {mean([r.get(n, 0.0) for r in runs]):.4f}"
                for n in names) + "]"
        lib = t.get("lib")
        if lib:
            c += (f", {'sdpa backward' if lib == 'sdpa bwd' else lib} "
                  f"{mean(t[f'{lab} {lib}']):.4f} ms (device "
                  f"{mean(t[f'{lab} {lib} device']):.4f})")
        return c

    sums: dict = {}  # the products' device ms per forward / step
    for (kernel, case), t in times.items():
        cols = "; ".join(col(t, lab) for lab in labels)
        print(f"{kernel} {case}: {cols}; bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}); {card}", flush=True)
        if kernel == "gemm":
            per = case.split(" stage")[0]
            per = f"{per} per {'forward' if per == 'K1' else 'step'}"
            for lab in labels + ["cublas", "bound"]:
                x = (t["bound_ms"] if lab == "bound" else
                     mean(t[f"{labels[0]} cublas device"]) if lab == "cublas"
                     else mean(t[f"{lab} device"]))
                sums.setdefault(per, {}).setdefault(lab, 0.0)
                sums[per][lab] += t["calls"] * x
    for per, by in sums.items():
        print(f"gemm {per}, device ms: " + ", ".join(
            f"{lab} {x:.4f}" for lab, x in by.items()) + f"; {card}",
            flush=True)
    with open(a.out, "w") as f:
        json.dump({"card": card, "versions": labels, "gemm_sums": sums,
                   "times": [{"kernel": k, "case": c, **t}
                             for (k, c), t in times.items()]}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
