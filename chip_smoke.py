#!/usr/bin/env python3
"""Runs the port's main paths — KSVQE eval scoring, Swin-T-3D eval scoring
(the swin_tiny_grpb model key) and KSVQE training — on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit;
2. builds the CUDA kernels from ``kvq_tpu_torch/ops/csrc`` (nvcc, sm_90a);
3. holds K1 (fused_swin_block) against its plain version at each shipped
   stage geometry and at swin_tiny_grpb_m's stages 0-1 ((4, 4, 4) windows),
   unshifted and shifted, and K2 (flash_attention_nobias_cl) at the nine
   CDM shapes, on seeded bf16 inputs;
4. holds K4 (train_swin_block, forward and backward) at the train
   geometries of stages 0-2 and K5 (window_attention_train, forward and
   backward) at stage 3's, unshifted and shifted, with DropPath
   multipliers, output and every gradient against the plain versions;
   then every product of K1 and K4 (the wgmma GEMM of ops/gemm.py in its
   forward, dX and dW layouts) at the shipped shapes against an f32
   torch.matmul, each timed beside one cuBLAS call and its bound;
5. holds K3 (flash_window_attention_packed) at the four padded stage
   geometries of the Swin-T-3D path and at swin_tiny_grpb_m's padded
   stages 2-3, unshifted and shifted, K6
   (flash_window_attention) at stage 0's in head-major layout and K7
   (flash_attention_nobias) at the nine CDM shapes in head-major layout,
   against their plain versions and scaled_dot_product_attention;
6. builds KSVQE + VQAHead at full width from seeded random weights in bf16,
   scores a few batches of the shipped eval shapes through the evaluator
   (``inference_test``), checks finite scores and 12 K1 + 9 K2 launches per
   forward, and compares the kernel path's score with the plain path's;
7. does the same for swin_tiny_grpb + VQAHead on the technical view of the
   KVQ val config (B=1, 96x288x288 as one clip): 12 K3 launches per forward
   and no other kernel; then one forward of swin_tiny_grpb_m (4 K1 and 8 K3
   launches at N=64) against its plain path;
8. trains the same model at full width through ``Trainer`` (f32 masters,
   bf16 compute) on seeded batches of the shipped train shapes (B=4, T=32):
   one kernel-path step against one plain-path step from the same weights
   and seed (loss and every gradient), then timed steps that must launch
   K4 10 + 10 and K5 2 + 2 times each, with a finite loss, finite updated
   parameters and a moving EMA;
9. prints times, steps/s, videos/s, peak memory and a JSON line of kernel
   records, and as its last line ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when CUDA is absent, when the package is not
beside this script, or when any phase fails.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM published dense peaks (NVIDIA H100 datasheet)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# Tolerances of kernel against plain version, both in bf16 on the card: the
# two round at different points (normalised vs unnormalised p, fused vs
# separate bias add), so they differ by a few bf16 ulps of the output scale.
K1_TOL = 3e-2   # x max(1, max|plain|)
K2_TOL = 2e-2   # x max(1, max|plain|)
SCORE_TOL = 5e-2  # kernel path vs plain path score, x max(1, |score|)
# K4/K5 gradients against the plain backward, x the gradient's own largest
# magnitude: up to six bf16-rounded products, and f32 atomic sums over up to
# 512 windows and 200k rows in another order than the plain version's.
GRAD_TOL = 5e-2
# One kernel-path train step against one plain-path step from the same
# weights, batch and generator: bf16 through the whole network and its
# backward.  Loss within LOSS_TOL x max(1, |loss|); all gradients together
# within TRAIN_GRAD_TOL of their norm; and each gradient of the Swin stages,
# the parameters whose gradients K4 and K5 produce, within TRAIN_GRAD_TOL of
# its own norm.  The other modules run the same plain code on both paths;
# their gradients see the kernels only through the rounding of what flows
# in, which cancellations amplify (the semantic FiLM's gate gradient is a
# dot product over 384-768 channels; the head's last bias has an exactly
# zero gradient, PLCC being shift-invariant), so they are reported.
LOSS_TOL = 2e-2
TRAIN_GRAD_TOL = 0.1

# Shipped geometry (config/Kwai_KSVQE.yml): B=1, T=96 as one clip,
# 9x9 fragments of 32 px, s2d-packed; Swin-T 3D, windows (8, 7, 7).
T = 96
STAGES = [  # (dims after patch embed/merges, C, heads, frag bias)
    ((48, 56, 56), 96, 3, True),
    ((48, 28, 28), 192, 6, True),
    ((48, 14, 14), 384, 12, True),
    ((48, 7, 7), 768, 24, False),
]
CDM = [  # (C, heads, h*w) after stages 1, 2, 3
    (384, 6, 14 * 14),
    (768, 12, 7 * 7),
    (768, 24, 7 * 7),
]

# Shipped train geometry (config/Kwai_KSVQE.yml): B=4, T=32 frames, 9x9
# fragments of 32 px, s2d-packed; the Swin stages then run at T/2 = 16.
TRAIN_B, TRAIN_T = 4, 32
TRAIN_STAGES = [
    ((16, 56, 56), 96, 3, True),
    ((16, 28, 28), 192, 6, True),
    ((16, 14, 14), 384, 12, True),
    ((16, 7, 7), 768, 24, False),
]
TRAIN_REPS = (1, 1, 3, 1)  # unshifted/shifted pairs per step: depth / 2
TRAIN_STEPS = 3            # timed train steps after the compared one

KSVQE_CONFIG = {  # the model block of config/Kwai_KSVQE.yml
    "name": "KSVQE",
    "model": {
        "type": "KSVQE",
        "compute_dtype": "bfloat16",
        "args": {"KSVQE": {
            "backbone": {
                "checkpoint": False, "use_pallas": True, "s2d_input": True,
                "num_samples": 1, "sample_type": "topkpertubation",
                "CLIP_location": 8, "cls_use": True, "tuning_stage": 1,
                "a1": 1, "a2": 2,
            },
            "head": {"in_channels": 768, "hidden_channels": 64},
        }},
    },
}


# The Swin-T-3D model keys score the technical view with no QRS in front: at
# the KVQ val view of config/Kwai_KSVQE_test.yml (9x9 fragments of 32 px, 3
# clips of 32 frames scored as one 96-frame clip) the trunk runs at
# 48x72x72 tokens, which no stage's (8, 7, 7) window divides: every block
# pads and takes K3.
SWIN_STAGES = [  # (dims after patch embed/merges, C, heads, frag bias)
    ((48, 72, 72), 96, 3, True),
    ((48, 36, 36), 192, 6, True),
    ((48, 18, 18), 384, 12, True),
    ((48, 9, 9), 768, 24, False),
]
SWIN_REPS = (1, 1, 3, 1)  # unshifted/shifted pairs per forward: depth / 2
# swin_tiny_grpb_m on the same view: its (4, 4, 4) windows divide stages 0-1
# (K1 at N=64) and pad stages 2-3 to 48x20x20 and 48x12x12 (K3 at N=64); no
# fragment bias on any stage
GRPB_M_WINDOW = (4, 4, 4)
GRPB_M_STAGES = [(dims, C, h, False) for dims, C, h, _ in SWIN_STAGES]


def swin_config(key: str, use_pallas: bool = True) -> dict:
    """The model block of a Swin-T-3D key (reference FAST-VQA configs:
    VQAHead on 768 channels, 64 hidden)."""
    return {"name": key, "model": {
        "type": key, "compute_dtype": "bfloat16",
        "args": {key: {
            "backbone": {"checkpoint": False, "use_pallas": use_pallas},
            "head": {"in_channels": 768, "hidden_channels": 64},
        }},
    }}


TRAIN_CONFIG = {  # config/Kwai_KSVQE.yml's schedule, optimizer and EMA
    **KSVQE_CONFIG,
    "num_epochs": 50, "warmup_epochs": 2.5, "ema": True, "ema_decay": 0.999,
    "batch_size": TRAIN_B,
    "optimizer": {"lr": 3e-5, "wd": 0.05, "backbone_lr_mult": 1.0},
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "?"


def cuda_ms(fn, iters: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def gemm_sass_check() -> None:
    """Counts the warpgroup products (HGMMA) in the GEMM library's SASS,
    with the toolkit's cuobjdump; fails if there are none."""
    from kvq_tpu_torch.ops import build

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    lib = str(build._lib_path("gemm"))
    if not os.path.exists(tool):
        print("gemm SASS: cuobjdump not found, not checked", flush=True)
        return
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300).stdout
    n = sum("HGMMA" in line for line in sass.splitlines())
    print(f"gemm SASS: {n} HGMMA (wgmma) instructions in "
          f"{os.path.basename(lib)}", flush=True)
    if not n:
        fail("the GEMM library has no wgmma instruction")


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# --------------------------------------------------------------------------
# kernel phases


def block_case(stage: int, shifted: bool, gen, stages=STAGES, batch=1,
               window=(8, 7, 7)):
    import torch

    from kvq_tpu_torch.nn.swin import expand_bias_planes, get_window_size
    from kvq_tpu_torch.ops.window_attention import WindowGeometry

    dims, C, h, use_frag = stages[stage]
    win, shift = get_window_size(
        dims, window,
        tuple(w // 2 for w in window) if shifted else (0, 0, 0))
    geo = WindowGeometry(batch=batch, dims=dims, window=win, shift=shift,
                         fragments=(1, 7, 7), num_heads=h, head_dim=C // h,
                         use_frag=use_frag)
    N, BW, hid = geo.n_tokens, batch * geo.n_windows, 4 * C
    dev = "cuda"

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale)

    bf = torch.bfloat16
    params = {
        "norm1_scale": (1 + rnd(C, scale=0.1)).to(bf),
        "norm1_bias": rnd(C, scale=0.1).to(bf),
        "qkv_w": rnd(3 * C, C, scale=C ** -0.5).to(bf),
        "qkv_b": rnd(3 * C, scale=0.1).to(bf),
        "proj_w": rnd(C, C, scale=C ** -0.5).to(bf),
        "proj_b": rnd(C, scale=0.1).to(bf),
        "norm2_scale": (1 + rnd(C, scale=0.1)).to(bf),
        "norm2_bias": rnd(C, scale=0.1).to(bf),
        "fc1_w": rnd(hid, C, scale=C ** -0.5).to(bf),
        "fc1_b": rnd(hid, scale=0.1).to(bf),
        "fc2_w": rnd(C, hid, scale=hid ** -0.5).to(bf),
        "fc2_b": rnd(C, scale=0.1).to(bf),
    }
    tl = math.prod(2 * w - 1 for w in window)
    rel = expand_bias_planes(rnd(tl, h, scale=0.5), window, N)
    frag = (expand_bias_planes(rnd(tl, h, scale=0.5), window, N)
            if use_frag else None)
    x = rnd(BW, N, C).to(bf)
    flops = 2 * BW * N * (12 * C * C) + 4 * BW * h * N * N * (C // h)
    nbytes = (2 * BW * N * C * 2 + 24 * C * C + (1 + use_frag) * h * N * N * 4)
    return (x, params, rel, frag, geo), flops, nbytes


def attention_cases(gen):
    """The nine K2 calls of one forward: (name, q, k, v, heads, scale)."""
    import torch

    cases = []
    bf = torch.bfloat16
    for m, (C, h, hw) in enumerate(CDM):
        tg = (T // 2) // 4
        q = torch.randn(4, tg * hw, C, generator=gen, device="cuda").to(bf)
        kv = torch.randn(2, 4, 196, C, generator=gen, device="cuda").to(bf)
        cases.append((f"cdm{m}.sem_cross", q, kv[0], kv[1], h, C ** -0.5))
        q = torch.randn(T // 2, hw, C, generator=gen, device="cuda").to(bf)
        kv = torch.randn(2, T // 2, 49, C, generator=gen, device="cuda").to(bf)
        cases.append((f"cdm{m}.dist_cross", q, kv[0], kv[1], h, C ** -0.5))
        qkv = torch.randn(hw, T // 2, 3 * C, generator=gen, device="cuda").to(bf)
        q, k, v = qkv.split(C, dim=-1)
        cases.append((f"cdm{m}.temporal", q, k, v, h, (C // h) ** -0.5))
    return cases


def kernel_phase(card: str):
    """K1 and K2 against their plain versions; returns timing records.
    K1 runs at KSVQE's four stage geometries, whose times make up its
    record, and at swin_tiny_grpb_m's stages 0-1 ((4, 4, 4) windows,
    N=64), checked and printed."""
    import torch
    import torch.nn.functional as F

    from kvq_tpu_torch.ops import window_attention as WA

    gen = torch.Generator(device="cuda").manual_seed(0)
    k1 = {"ms": 0.0, "plain_ms": 0.0, "bound": [0.0, 0.0], "err": 0.0,
          "rows": []}
    # (model, stage, stage table, window, unshifted/shifted pairs per KSVQE
    # forward: depth / 2 of depths (2, 2, 6, 2); 0 outside that forward)
    cases = [("KSVQE", s, STAGES, (8, 7, 7), (1, 1, 3, 1)[s])
             for s in range(4)]
    cases += [("swin_tiny_grpb_m", s, GRPB_M_STAGES, GRPB_M_WINDOW, 0)
              for s in range(2)]
    for model, stage, stages, window, reps in cases:
        for shifted in (False, True):
            args, flops, nbytes = block_case(stage, shifted, gen, stages,
                                             window=window)
            out = WA.fused_swin_block(*args)
            ref = WA.fused_swin_block_plain(*args)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            scale = max(1.0, ref.float().abs().max().item())
            ok = math.isfinite(err) and err <= K1_TOL * scale
            ms = cuda_ms(lambda: WA.fused_swin_block(*args))
            pms = cuda_ms(lambda: WA.fused_swin_block_plain(*args), 5)
            b, by = bound_ms(nbytes, flops)
            geo = args[4]
            print(f"K1 {model} stage{stage} shift={geo.shift} "
                  f"BW={geo.n_windows} N={geo.n_tokens} "
                  f"C={args[0].shape[2]}: max|d|={err:.4g} "
                  f"(tol {K1_TOL * scale:.4g}) kernel {ms:.4f} ms, plain "
                  f"{pms:.4f} ms, bound {b:.4f} ms ({by}); {card}",
                  flush=True)
            if not ok:
                fail(f"K1 {model} stage {stage} shift {geo.shift}: "
                     f"max|d| {err}")
            k1["ms"] += reps * ms
            k1["plain_ms"] += reps * pms
            k1["bound"][0] += reps * nbytes / PEAK_BYTES * 1e3
            k1["bound"][1] += reps * flops / PEAK_BF16_FLOPS * 1e3
            k1["err"] = max(k1["err"], err)
            k1["rows"].append((model, stage, geo.n_tokens, geo.shift, err,
                               ms, pms, b, by))
            del args
    k2 = {"ms": 0.0, "plain_ms": 0.0, "lib_ms": 0.0, "bound": [0.0, 0.0],
          "err": 0.0, "rows": []}
    for name, q, k, v, h, scale in attention_cases(gen):
        out = WA.flash_attention_nobias_cl(q, k, v, h, scale)
        ref = WA.attention_nobias_plain(q, k, v, h, scale)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol_scale = max(1.0, ref.float().abs().max().item())
        if not (math.isfinite(err) and err <= K2_TOL * tol_scale):
            fail(f"K2 {name}: max|d| {err}")
        X, N, C = q.shape
        M = k.shape[1]
        hd = C // h
        qh, kh, vh = (t.reshape(X, -1, h, hd).transpose(1, 2).contiguous()
                      for t in (q, k, v))
        ms = cuda_ms(lambda: WA.flash_attention_nobias_cl(q, k, v, h, scale))
        pms = cuda_ms(lambda: WA.attention_nobias_plain(q, k, v, h, scale), 5)
        lms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, scale=scale))
        flops = 4 * X * N * M * C
        nbytes = (2 * N + 2 * M) * X * C * 2
        b, by = bound_ms(nbytes, flops)
        print(f"K2 {name} q{tuple(q.shape)} kv{tuple(k.shape)} h={h}: "
              f"max|d|={err:.4g} (tol {K2_TOL * tol_scale:.4g}) kernel "
              f"{ms:.4f} ms, plain {pms:.4f} ms, sdpa {lms:.4f} ms, bound "
              f"{b:.4f} ms ({by}); {card}", flush=True)
        k2["ms"] += ms
        k2["plain_ms"] += pms
        k2["lib_ms"] += lms
        k2["bound"][0] += nbytes / PEAK_BYTES * 1e3
        k2["bound"][1] += flops / PEAK_BF16_FLOPS * 1e3
        k2["err"] = max(k2["err"], err)
        k2["rows"].append((name, err, ms, pms, lms, b, by))
    return k1, k2


def _grad_err(name, got, want):
    """max|got - want| and its tolerance, GRAD_TOL x max|want|."""
    err = (got.float() - want.float()).abs().max().item()
    tol = GRAD_TOL * max(want.float().abs().max().item(), 1e-6)
    if not (math.isfinite(err) and err <= tol):
        fail(f"{name}: max|d| {err} > tol {tol}")
    return err


def _multipliers(B, nW, gen):
    """(B*nW,) DropPath multipliers of rate 0.1, one draw per sample."""
    import torch

    keep = torch.rand(B, generator=gen, device="cuda") < 0.9
    return (keep.float() / 0.9).repeat_interleave(nW)


def _agg():
    return {"ms": 0.0, "plain_ms": 0.0, "lib_ms": 0.0, "bound": [0.0, 0.0],
            "err": 0.0, "rows": []}


def _add(agg, reps, ms, pms, nbytes, flops, err, lms=None):
    agg["ms"] += reps * ms
    agg["plain_ms"] += reps * pms
    agg["bound"][0] += reps * nbytes / PEAK_BYTES * 1e3
    agg["bound"][1] += reps * flops / PEAK_BF16_FLOPS * 1e3
    agg["err"] = max(agg["err"], err)
    if lms is not None:
        agg["lib_ms"] += reps * lms


def train_kernel_phase(card: str):
    """K4 at the train geometries of stages 0-2 and K5 at stage 3's (B=4,
    T=32), forward and backward, against their plain versions; returns
    timing records of the calls of one train step."""
    import torch
    import torch.nn.functional as F

    from kvq_tpu_torch.ops import train_attention as TA
    from kvq_tpu_torch.ops.window_attention import (
        fused_swin_block_plain, gate_and_mask)

    gen = torch.Generator(device="cuda").manual_seed(1)
    k4f, k4b, k5f, k5b = _agg(), _agg(), _agg(), _agg()
    for stage in range(3):
        for shifted in (False, True):
            (x, params, rel, frag, geo), flops, _ = block_case(
                stage, shifted, gen, TRAIN_STAGES, TRAIN_B)
            BW, N, C = x.shape
            h, nW = geo.num_heads, geo.n_windows
            scale = geo.head_dim ** -0.5
            dp1, dp2 = _multipliers(TRAIN_B, nW, gen), _multipliers(
                TRAIN_B, nW, gen)
            dout = torch.randn(x.shape, generator=gen, device="cuda").to(
                torch.bfloat16)
            args = (x, params, rel, frag, geo, scale, dp1, dp2)
            out = TA.train_swin_block_fwd(*args)
            ref = fused_swin_block_plain(*args)
            dx, g, drel, dfrag = TA.train_swin_block_bwd(*args, dout)
            rdx, rg, rdrel, rdfrag = TA.train_swin_block_bwd_plain(*args,
                                                                   dout)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = K1_TOL * max(1.0, ref.float().abs().max().item())
            if not (math.isfinite(err) and err <= tol):
                fail(f"K4 forward stage {stage} shift {geo.shift}: max|d| "
                     f"{err}")
            tag = f"K4 stage{stage} shift={geo.shift}"
            gerr = {"dx": _grad_err(f"{tag} dx", dx, rdx),
                    "drel": _grad_err(f"{tag} drel", drel, rdrel)}
            if frag is not None:
                gerr["dfrag"] = _grad_err(f"{tag} dfrag", dfrag, rdfrag)
            for k in g:
                gerr[k] = _grad_err(f"{tag} {k}", g[k].reshape(rg[k].shape),
                                    rg[k])
            del out, ref, dx, g, drel, dfrag, rdx, rg, rdrel, rdfrag
            ms_f = cuda_ms(lambda: TA.train_swin_block_fwd(*args), 10)
            pms_f = cuda_ms(lambda: fused_swin_block_plain(*args), 3)
            ms_b = cuda_ms(lambda: TA.train_swin_block_bwd(*args, dout), 5)
            pms_b = cuda_ms(
                lambda: TA.train_swin_block_bwd_plain(*args, dout), 2)
            planes = (1 + int(frag is not None)) * h * N * N * 4
            w = 12 * C * C
            by_f = 2 * BW * N * C * 2 + w * 2 + planes + 2 * BW * 4
            by_b = 3 * BW * N * C * 2 + w * 2 + w * 4 + 2 * planes + 2 * BW * 4
            bf, byf = bound_ms(by_f, flops)
            bb, byb = bound_ms(by_b, 3 * flops)
            reps = TRAIN_REPS[stage]
            _add(k4f, reps, ms_f, pms_f, by_f, flops, err)
            _add(k4b, reps, ms_b, pms_b, by_b, 3 * flops, max(gerr.values()))
            k4f["rows"].append((stage, geo.shift, BW, C, err, ms_f, pms_f, bf,
                                byf))
            k4b["rows"].append((stage, geo.shift, BW, C, gerr, ms_b, pms_b,
                                bb, byb))
            print(f"{tag} BW={BW} C={C}: forward max|d|={err:.4g} (tol "
                  f"{tol:.4g}) kernel {ms_f:.4f} ms, plain {pms_f:.4f} ms, "
                  f"bound {bf:.4f} ms ({byf}); backward max|d| by grad "
                  f"{json.dumps({k: float(f'{v:.3g}') for k, v in gerr.items()})}"
                  f" kernel {ms_b:.4f} ms, plain {pms_b:.4f} ms, bound "
                  f"{bb:.4f} ms ({byb}); {card}", flush=True)
            del args, x, params, dout
            torch.cuda.empty_cache()
    dims, C, h, use_frag = TRAIN_STAGES[3]
    for shift in ((0, 0, 0), (4, 0, 0)):
        from kvq_tpu_torch.nn.swin import expand_bias_planes, get_window_size
        from kvq_tpu_torch.ops.window_attention import WindowGeometry

        win, sh = get_window_size(dims, (8, 7, 7), shift)
        geo = WindowGeometry(batch=TRAIN_B, dims=dims, window=win, shift=sh,
                             fragments=(1, 7, 7), num_heads=h,
                             head_dim=C // h, use_frag=use_frag)
        N, hd, nW = geo.n_tokens, geo.head_dim, geo.n_windows
        BW = TRAIN_B * nW
        scale = hd ** -0.5
        q, k, v, dout = (torch.randn(BW, h, N, hd, generator=gen,
                                     device="cuda").to(torch.bfloat16)
                         for _ in range(4))
        rel = expand_bias_planes(
            torch.randn(15 * 13 * 13, h, generator=gen, device="cuda") * 0.5,
            (8, 7, 7), N)
        frag = None
        args = (q, k, v, rel, frag, geo, scale)
        out, lse = TA.window_attention_train_fwd(*args)
        ref = TA.window_attention_train_plain(*args)
        grads = TA.window_attention_train_bwd(*args, out, lse, dout)
        want = TA.window_attention_train_bwd_plain(*args, out, dout)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = K2_TOL * max(1.0, ref.float().abs().max().item())
        if not (math.isfinite(err) and err <= tol):
            fail(f"K5 forward shift {sh}: max|d| {err}")
        tag = f"K5 stage3 shift={sh}"
        gerr = {n: _grad_err(f"{tag} {n}", a, b)
                for n, a, b in zip(("dq", "dk", "dv", "drel"), grads, want)}
        ms_f = cuda_ms(lambda: TA.window_attention_train_fwd(*args), 20)
        pms_f = cuda_ms(lambda: TA.window_attention_train_plain(*args), 5)
        ms_b = cuda_ms(lambda: TA.window_attention_train_bwd(
            *args, out, lse, dout), 20)
        pms_b = cuda_ms(lambda: TA.window_attention_train_bwd_plain(
            *args, out, dout), 5)
        # the library yardstick: SDPA on the same q, k, v with the blended
        # bias and seam mask materialised as a float mask, forward, and its
        # backward into q, k, v and the mask
        _, mask = gate_and_mask(geo, "cuda")
        bias = (rel[None].expand(nW, -1, -1, -1) if mask is None
                else rel[None] + mask[:, None])
        bias = (bias.repeat(TRAIN_B, 1, 1, 1).to(torch.bfloat16)
                .requires_grad_())
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        lms_f = cuda_ms(lambda: F.scaled_dot_product_attention(
            *leaves, attn_mask=bias, scale=scale), 20)
        y = F.scaled_dot_product_attention(*leaves, attn_mask=bias,
                                           scale=scale)
        lms_b = cuda_ms(lambda: torch.autograd.grad(
            y, leaves + [bias], dout, retain_graph=True), 20)
        del y, bias, leaves
        planes = h * N * N * 4
        flops_f = 4 * BW * h * N * N * hd
        by_f = 4 * BW * h * N * hd * 2 + planes + BW * h * N * 4
        by_b = 8 * BW * h * N * hd * 2 + 2 * planes + BW * h * N * 4
        bf, byf = bound_ms(by_f, flops_f)
        bb, byb = bound_ms(by_b, 2.5 * flops_f)
        _add(k5f, 1, ms_f, pms_f, by_f, flops_f, err, lms_f)
        _add(k5b, 1, ms_b, pms_b, by_b, 2.5 * flops_f, max(gerr.values()),
             lms_b)
        k5f["rows"].append((3, sh, BW, C, err, ms_f, pms_f, lms_f, bf, byf))
        k5b["rows"].append((3, sh, BW, C, gerr, ms_b, pms_b, lms_b, bb, byb))
        print(f"{tag} BW={BW} h={h}: forward max|d|={err:.4g} (tol "
              f"{tol:.4g}) kernel {ms_f:.4f} ms, plain {pms_f:.4f} ms, sdpa "
              f"{lms_f:.4f} ms, bound {bf:.4f} ms ({byf}); backward max|d| "
              f"by grad {json.dumps({n: float(f'{e:.3g}') for n, e in gerr.items()})}"
              f" kernel {ms_b:.4f} ms, plain {pms_b:.4f} ms, sdpa backward "
              f"{lms_b:.4f} ms, bound {bb:.4f} ms ({byb}); {card}",
              flush=True)
    return k4f, k4b, k5f, k5b


# The block's products: (product, N, K, epilogue) of one block of width C in
# the forward layout; forward epilogues: "bias", "gelu" (fc1), "gelu_pre"
# (fc1 keeping its pre-activation, K4's recompute), "res" (eval residual),
# "res_dp" (residual with the DropPath multipliers).
GEMM_TOL = 2e-2      # bf16 outputs, x max(1, max|reference|)
GEMM_TOL_F32 = 1e-3  # f32 outputs (dX's f32 epilogue, dW's split-K sums)


def gemm_cases():
    """Every product of K1 at the four KSVQE eval stages and of K4 at train
    stages 0-2: (kernel, stage, product, layout, M, N, K, epilogue, calls),
    with the calls per KSVQE forward (K1) or per train step (K4: qkv and
    proj run in the forward and in the backward's recompute, fc1 once
    without and once with its pre-activation kept, fc2 once; dX and dW once
    per block).  For dW, M and N are the weight's (out, in) and K the token
    rows."""
    out = []
    for s, (dims, C, _, _) in enumerate(STAGES):
        M, blocks = math.prod(dims), 2 * (1, 1, 3, 1)[s]
        for prod, N, K, epi in (("qkv", 3 * C, C, "bias"),
                                ("proj", C, C, "res"),
                                ("fc1", 4 * C, C, "gelu"),
                                ("fc2", C, 4 * C, "res")):
            out.append(("K1", s, prod, "forward", M, N, K, epi, blocks))
    for s in range(3):
        dims, C, _, _ = TRAIN_STAGES[s]
        M, b = TRAIN_B * math.prod(dims), 2 * TRAIN_REPS[s]
        for prod, N, K, epi, calls in (
                ("qkv", 3 * C, C, "bias", 2 * b),
                ("proj", C, C, "res_dp", 2 * b),
                ("fc1", 4 * C, C, "gelu", b),
                ("fc1 keep pre", 4 * C, C, "gelu_pre", b),
                ("fc2", C, 4 * C, "res_dp", b)):
            out.append(("K4 fwd", s, prod, "forward", M, N, K, epi, calls))
        for prod, N, K, epi in (("fc2", 4 * C, C, "gelu_bwd"),
                                ("fc1", C, 4 * C, "f32"),
                                ("proj", C, C, "bf16"),
                                ("qkv", C, 3 * C, "f32")):
            out.append(("K4 bwd", s, f"{prod} dX", "dx", M, N, K, epi, b))
        for prod, n_out, n_in in (("fc2", C, 4 * C), ("fc1", 4 * C, C),
                                  ("proj", C, C), ("qkv", 3 * C, C)):
            out.append(("K4 bwd", s, f"{prod} dW", "dw", n_out, n_in, M,
                        "f32", b))
    return out


def gemm_case(case, gen, linear, input_grad, weight_grad):
    """Inputs on the card for one of :func:`gemm_cases` and (run, reference,
    cublas, bytes, FLOPs, tol): ``run`` calls the port's wrapper (passed in,
    so that a timing tool can hand another version's), ``reference`` is an
    f32 torch.matmul of the same bf16 inputs with the epilogue rounded where
    the kernel rounds, ``cublas`` one torch call of the same product in bf16
    (the library yardstick), and bytes count each input and output once."""
    import torch
    import torch.nn.functional as F

    _, _, _, layout, M, N, K, epi, _ = case
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(bf)

    if layout == "forward":
        a, w, bias = rnd(M, K), rnd(N, K, scale=K ** -0.5), rnd(N, scale=0.1)
        res = rnd(M, N) if epi.startswith("res") else None
        rows = 8 * 7 * 7  # tokens per window, one DropPath multiplier each
        dp = (_multipliers(-(-M // rows), 1, gen) if epi == "res_dp"
              else None)
        gelu, keep = epi.startswith("gelu"), epi == "gelu_pre"

        def run():
            return linear(a, w, bias, res=res, gelu=gelu, dp=dp, dp_rows=rows,
                          keep_pre=keep)[0]

        def reference():
            v = a.float() @ w.float().T + bias.float()
            y = (F.gelu(v) if gelu else v).to(bf)
            if dp is not None:
                y = (y.float() * dp.repeat_interleave(rows)[:M, None]
                     ).to(bf)
            return y if res is None else (res.float() + y.float()).to(bf)

        def cublas():
            return F.linear(a, w, bias)

        nbytes = 2 * (M * K + N * K + N + M * N * (1 + (res is not None)
                                                   + keep))
        tol = GEMM_TOL
    elif layout == "dx":
        code = {"f32": 1, "bf16": 3, "gelu_bwd": 4}[epi]
        dy, w = rnd(M, K), rnd(K, N, scale=K ** -0.5)
        aux = rnd(M, N) if epi == "gelu_bwd" else None

        def run():
            return input_grad(dy, w, code, aux)

        def reference():
            acc = dy.float() @ w.float()
            if aux is not None:
                x = aux.float()
                acc = acc * (0.5 * (1 + torch.erf(x * 2 ** -0.5))
                             + x * torch.exp(-0.5 * x * x)
                             * (2 * math.pi) ** -0.5)
            return acc if epi == "f32" else acc.to(bf)

        def cublas():
            return torch.matmul(dy, w)

        nbytes = (2 * (M * K + K * N) + M * N * (4 if epi == "f32" else 2)
                  + (2 * M * N if aux is not None else 0))
        tol = GEMM_TOL_F32 if epi == "f32" else GEMM_TOL
    else:  # dW: (M, N) = (n_out, n_in) over K token rows
        dy, x = rnd(K, M), rnd(K, N)

        def run():
            return weight_grad(dy, x)

        def reference():
            return dy.float().T @ x.float()

        def cublas():
            return torch.matmul(dy.T, x)

        nbytes = 2 * K * (M + N) + 4 * M * N
        tol = GEMM_TOL_F32
    return run, reference, cublas, nbytes, 2 * M * N * K, tol


def gemm_phase(card: str):
    """Every product of K1 and K4 (the layouts forward, dX, dW) at the shipped
    shapes against an f32 torch.matmul of the same inputs, timed beside one
    cuBLAS call of the same product and its bound; returns per-case rows and
    the sums per KSVQE forward and per train step."""
    import torch

    from kvq_tpu_torch.ops import gemm as G

    gen = torch.Generator(device="cuda").manual_seed(4)
    rows, sums = [], {}
    for case in gemm_cases():
        kernel, stage, prod, layout, M, N, K, epi, calls = case
        run, reference, cublas, nbytes, flops, tol = gemm_case(
            case, gen, G.linear, G.input_grad, G.weight_grad)
        got, want = run(), reference()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        lim = tol * max(1.0, want.float().abs().max().item())
        del got, want
        if not (math.isfinite(err) and err <= lim):
            fail(f"GEMM {kernel} stage {stage} {prod}: max|d| {err} > {lim}")
        ms, lms = cuda_ms(run), cuda_ms(cublas)
        b, by = bound_ms(nbytes, flops)
        plan = G.plan_gemm(layout, M, N, K, G.sm_count(0))
        print(f"GEMM {kernel} stage{stage} {prod} ({layout}, M={M} N={N} "
              f"K={K}, BN={plan.bn}, splits={plan.splits}, {calls} calls): "
              f"max|d|={err:.4g} (tol {lim:.4g}) kernel {ms:.4f} ms, cuBLAS "
              f"{lms:.4f} ms, bound {b:.4f} ms ({by}); {card}", flush=True)
        rows.append({"kernel": kernel, "stage": stage, "product": prod,
                     "layout": layout, "M": M, "N": N, "K": K, "bn": plan.bn,
                     "splits": plan.splits, "calls": calls, "err": err,
                     "ms": ms, "cublas_ms": lms, "bound_ms": b,
                     "bound_by": by})
        per = "per forward" if kernel == "K1" else "per step"
        t = sums.setdefault(f"{kernel} {per}", [0.0, 0.0, 0.0])
        t[0] += calls * ms
        t[1] += calls * lms
        t[2] += calls * b
        torch.cuda.empty_cache()
    for key, (ms, lms, b) in sums.items():
        print(f"GEMM {key}: kernel {ms:.4f} ms, cuBLAS {lms:.4f} ms, bound "
              f"{b:.4f} ms; {card}", flush=True)
    return {"rows": rows, "sums": sums}


def padded_geometry(dims, C, h, use_frag, shifted, window=(8, 7, 7)):
    """The geometry K3 runs at for a block over ``dims`` tokens (B=1): the
    window and shift after clamping, the dims padded to whole windows."""
    from kvq_tpu_torch.nn.swin import get_window_size
    from kvq_tpu_torch.ops.window_attention import WindowGeometry

    cfg_shift = tuple(w // 2 for w in window) if shifted else (0, 0, 0)
    win, shift = get_window_size(dims, window, cfg_shift)
    padded = tuple(d + (w - d % w) % w for d, w in zip(dims, win))
    return WindowGeometry(batch=1, dims=padded, window=win, shift=shift,
                          fragments=(1, 7, 7), num_heads=h, head_dim=C // h,
                          use_frag=use_frag)


def window_attn_mask(rel, frag, geo):
    """SDPA's float mask for a window attention at B=1: the gate-blended
    bias plus the seam mask, (nW, h, N, N) in bf16."""
    import torch

    from kvq_tpu_torch.ops.window_attention import gate_and_mask

    gate, mask = gate_and_mask(geo, "cuda")
    if frag is None:
        bias = rel[None].expand(geo.n_windows, -1, -1, -1)
    else:
        g = gate[:, None]
        bias = rel[None] * g + frag[None] * (1.0 - g)
    if mask is not None:
        bias = bias + mask[:, None]
    return bias.to(torch.bfloat16)


def eval_attention_phase(card: str):
    """K3 at the four stage shapes of the Swin-T-3D path, unshifted and
    shifted; K6 on stage 0's inputs in head-major layout; K7 at K2's nine
    CDM shapes in head-major layout.  Each against its plain version and
    scaled_dot_product_attention; returns timing records."""
    import torch
    import torch.nn.functional as F

    from kvq_tpu_torch.nn.swin import expand_bias_planes
    from kvq_tpu_torch.ops import window_attention as WA

    gen = torch.Generator(device="cuda").manual_seed(2)
    bf = torch.bfloat16
    k3, k6, k7 = _agg(), _agg(), _agg()

    def check(name, out, ref, tol_rel):
        err = (out.float() - ref.float()).abs().max().item()
        tol = tol_rel * max(1.0, ref.float().abs().max().item())
        if not (math.isfinite(err) and err <= tol):
            fail(f"{name}: max|d| {err} > tol {tol}")
        return err, tol

    # (model, stage, stage table, window, unshifted/shifted pairs per
    # swin_tiny_grpb forward; 0 for swin_tiny_grpb_m's rows, checked and
    # printed outside that record)
    cases = [("swin_tiny_grpb", s, SWIN_STAGES, (8, 7, 7), SWIN_REPS[s])
             for s in range(4)]
    cases += [("swin_tiny_grpb_m", s, GRPB_M_STAGES, GRPB_M_WINDOW, 0)
              for s in (2, 3)]
    for model, stage, stages, window, reps in cases:
        dims, C, h, use_frag = stages[stage]
        for shifted in (False, True):
            geo = padded_geometry(dims, C, h, use_frag, shifted, window)
            N, BW, hd = geo.n_tokens, geo.n_windows, geo.head_dim
            scale = hd ** -0.5
            qkv = torch.randn(BW, N, 3 * C, generator=gen,
                              device="cuda").to(bf)
            tables = torch.randn(2, math.prod(2 * w - 1 for w in window), h,
                                 generator=gen, device="cuda") * 0.5
            rel = expand_bias_planes(tables[0], window, N)
            frag = (expand_bias_planes(tables[1], window, N) if use_frag
                    else None)
            args = (qkv, rel, frag, geo, scale)
            tag = (f"K3 {model} stage{stage} dims={geo.dims} "
                   f"shift={geo.shift}")
            err, tol = check(tag, WA.flash_window_attention_packed(*args),
                             WA.flash_window_attention_packed_plain(*args),
                             K2_TOL)
            ms = cuda_ms(lambda: WA.flash_window_attention_packed(*args))
            pms = cuda_ms(lambda: WA.flash_window_attention_packed_plain(
                *args), 3)
            qh, kh, vh = (t.contiguous() for t in
                          qkv.view(BW, N, 3, h, hd).permute(2, 0, 3, 1, 4))
            amask = window_attn_mask(rel, frag, geo)
            lms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=amask, scale=scale))
            planes = (1 + use_frag) * h * N * N * 4
            flops = 4 * BW * h * N * N * hd
            nbytes = BW * N * 3 * C * 2 + BW * N * C * 2 + planes
            b, by = bound_ms(nbytes, flops)
            _add(k3, reps, ms, pms, nbytes, flops, err, lms)
            k3["rows"].append((model, stage, geo.dims, geo.shift, BW, C, err,
                               ms, pms, lms, b, by))
            print(f"{tag} BW={BW} N={N} C={C}: max|d|={err:.4g} (tol "
                  f"{tol:.4g}) kernel {ms:.4f} ms, plain {pms:.4f} ms, sdpa "
                  f"{lms:.4f} ms, bound {b:.4f} ms ({by}); {card}",
                  flush=True)
            if model == "swin_tiny_grpb" and stage == 0:
                # K6 on the same inputs, head-major
                hargs = (qh, kh, vh, rel, frag, geo, scale)
                tag = f"K6 stage0 shift={geo.shift}"
                err, tol = check(tag, WA.flash_window_attention(*hargs),
                                 WA.flash_window_attention_plain(*hargs),
                                 K2_TOL)
                ms = cuda_ms(lambda: WA.flash_window_attention(*hargs))
                pms = cuda_ms(lambda: WA.flash_window_attention_plain(
                    *hargs), 3)
                nbytes = 4 * BW * h * N * hd * 2 + planes
                b, by = bound_ms(nbytes, flops)
                _add(k6, 1, ms, pms, nbytes, flops, err, lms)
                k6["rows"].append((0, geo.shift, BW, h, err, ms, pms, lms, b,
                                   by))
                print(f"{tag} q/k/v ({BW}, {h}, {N}, {hd}): max|d|={err:.4g} "
                      f"(tol {tol:.4g}) kernel {ms:.4f} ms, plain {pms:.4f} "
                      f"ms, sdpa {lms:.4f} ms, bound {b:.4f} ms ({by}); "
                      f"{card}", flush=True)
                del hargs
            del args, qkv, qh, kh, vh, amask, rel, frag
            torch.cuda.empty_cache()
    # the ragged tails and the head dim no Swin-T stage has, checked and
    # printed outside the record: clamped windows (N = 100 and 50, with a
    # fragment bias) and hd = 64 at N = 64, shifted
    for dims, window, shift, use_frag, hd in (
            ((4, 5, 5), (4, 5, 5), (0, 0, 0), True, 32),
            ((2, 5, 5), (2, 5, 5), (0, 0, 0), True, 32),
            ((8, 12, 12), (4, 4, 4), (2, 2, 2), False, 64)):
        h = 3
        geo = WA.WindowGeometry(batch=64, dims=dims, window=window,
                                shift=shift, fragments=(1, 7, 7),
                                num_heads=h, head_dim=hd, use_frag=use_frag)
        N, BW, C = geo.n_tokens, geo.batch * geo.n_windows, h * hd
        qkv = torch.randn(BW, N, 3 * C, generator=gen, device="cuda").to(bf)
        rel = torch.randn(h, N, N, generator=gen, device="cuda")
        frag = (torch.randn(h, N, N, generator=gen, device="cuda")
                if use_frag else None)
        args = (qkv, rel, frag, geo, hd ** -0.5)
        tag = f"K3 tail dims={dims} window={window} shift={shift} hd={hd}"
        err, tol = check(tag, WA.flash_window_attention_packed(*args),
                         WA.flash_window_attention_packed_plain(*args),
                         K2_TOL)
        ms = cuda_ms(lambda: WA.flash_window_attention_packed(*args))
        pms = cuda_ms(lambda: WA.flash_window_attention_packed_plain(*args),
                      3)
        qh, kh, vh = (t.contiguous() for t in
                      qkv.view(BW, N, 3, h, hd).permute(2, 0, 3, 1, 4))
        amask = window_attn_mask(rel, frag, geo)
        amask = amask.repeat(geo.batch, 1, 1, 1)
        lms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=amask, scale=hd ** -0.5))
        b, by = bound_ms(BW * N * 4 * C * 2 + (1 + use_frag) * h * N * N * 4,
                         4 * BW * h * N * N * hd)
        print(f"{tag} BW={BW} N={N}: max|d|={err:.4g} (tol {tol:.4g}) "
              f"kernel {ms:.4f} ms, plain {pms:.4f} ms, sdpa {lms:.4f} ms, "
              f"bound {b:.4f} ms ({by}); {card}", flush=True)
        del args, qkv, qh, kh, vh, amask
    for name, q, k, v, h, scale in attention_cases(gen):
        X, N, C = q.shape
        M = k.shape[1]
        hd = C // h
        qh, kh, vh = (t.reshape(X, -1, h, hd).transpose(1, 2).contiguous()
                      for t in (q, k, v))
        tag = f"K7 {name}"
        err, tol = check(tag, WA.flash_attention_nobias(qh, kh, vh, scale),
                         WA.attention_nobias_heads_plain(qh, kh, vh, scale),
                         K2_TOL)
        ms = cuda_ms(lambda: WA.flash_attention_nobias(qh, kh, vh, scale))
        pms = cuda_ms(lambda: WA.attention_nobias_heads_plain(
            qh, kh, vh, scale), 5)
        lms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, scale=scale))
        flops = 4 * X * N * M * C
        nbytes = (2 * N + 2 * M) * X * C * 2
        b, by = bound_ms(nbytes, flops)
        _add(k7, 1, ms, pms, nbytes, flops, err, lms)
        k7["rows"].append((name, err, ms, pms, lms, b, by))
        print(f"{tag} q{tuple(qh.shape)} kv{tuple(kh.shape)}: max|d|="
              f"{err:.4g} (tol {tol:.4g}) kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms, sdpa {lms:.4f} ms, bound {b:.4f} ms ({by}); "
              f"{card}", flush=True)
    return k3, k6, k7


N_BATCHES = 8  # scored batches of each timed main-path run


def make_batch(rng, i: int) -> dict:
    """One eval batch in the Loader's format at the shipped shapes: the
    9x9x32 px fragment mosaic of 96 frames, s2d-packed on the host, and the
    224 px resize view."""
    from kvq_tpu_torch.data.fragments import s2d_pack

    mosaic = rng.standard_normal((T, 288, 288, 3), dtype=np.float32)
    return {
        "fragment": s2d_pack(mosaic)[None],                 # (1,48,72,72,96)
        "resize_video": rng.standard_normal((1, T, 224, 224, 3),
                                            dtype=np.float32),
        "label": np.asarray([rng.normal()], np.float32),
        "dis_label": np.asarray([i % 4], np.int32),
        "video_name": [f"smoke_{i:03d}.mp4"],
        "num_clips": [{"technical": 3}],
    }


FAMILIES = ("kvq_window_attention", "kvq_attention_bwd", "kvq_gemm",
            "kvq_layernorm", "kvq_train_other", "kvq_nobias_attention",
            "conv (cuDNN)", "matmul (cuBLAS)", "other")


def _family(name: str) -> str:
    low = name.lower()
    if "flash_attention_kernel" in name:
        return ("kvq_window_attention" if "true" in low
                else "kvq_nobias_attention")
    if "attention_bwd_kernel" in name:
        return "kvq_attention_bwd"
    if "kvq" in name and "gemm_kernel" in name:
        return "kvq_gemm"
    if "kvq" in name and "layernorm" in name:
        return "kvq_layernorm"
    if "kvq" in name:  # column sums, row scales, the backward's D
        return "kvq_train_other"
    if "conv" in low or "cudnn" in low or "implicit" in low:
        return "conv (cuDNN)"
    if ("gemm" in low or "cutlass" in low or "sm90" in low
            or "nvjet" in low):  # nvjet: cuBLASLt's own Hopper kernels
        return "matmul (cuBLAS)"
    return "other"


def profile_device(fn) -> dict:
    """Device time by kernel family over one call of ``fn``
    (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    top = []
    fam = {k: 0.0 for k in FAMILIES}
    syncs = {}  # host waits on the card inside the call, by API call
    host = []   # host ops by self CPU time (profiled, so inflated)
    launches = 0
    for evt in prof.key_averages():
        if "Synchronize" in evt.key:
            syncs[evt.key] = evt.count
        if evt.key in ("cudaLaunchKernel", "cuLaunchKernelEx",
                       "cuLaunchKernel", "cudaLaunchKernelExC"):
            launches += evt.count
        if getattr(evt, "device_type", None) is not None and \
                str(evt.device_type) != "DeviceType.CUDA":
            host.append((evt.self_cpu_time_total / 1e3, evt.count,
                         evt.key[:80]))
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if not us:
            continue
        top.append((us / 1e3, evt.count, evt.key[:120]))
        fam[_family(evt.key)] += us / 1e3
    busy = sum(fam.values())
    top.sort(reverse=True)
    host.sort(reverse=True)
    return {"wall_ms": wall, "device_ms": busy, "families_ms": fam,
            "syncs": syncs, "launch_calls": launches, "top_kernels": top[:15],
            "top_host_ops": host[:15]}


def main_path(card: str) -> dict:
    import torch

    from kvq_tpu_torch.data.pipeline import (
        host_tensors, pad_batch_rows, reshape_for_clips)
    from kvq_tpu_torch.models.vqa_network import build_model
    from kvq_tpu_torch.train.evaluator import Evaluator

    t0 = time.time()
    model = build_model(KSVQE_CONFIG, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: KSVQE + VQAHead, {n_params} parameters, bf16, seeded "
          f"random weights; built in {time.time() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    batches = [make_batch(rng, i) for i in range(N_BATCHES)]
    ev = Evaluator(KSVQE_CONFIG, model=model, device="cuda")
    out_path = os.path.join(tempfile.mkdtemp(prefix="kvq_smoke_"), "output.txt")
    ev.inference_test(batches[:1], out_path)  # warm-up
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    results = ev.inference_test(batches, out_path)
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    t0 = time.perf_counter()
    ev.inference_test(batches, out_path + ".again")  # the run-to-run spread
    wall2 = time.perf_counter() - t0
    print(f"main path: {len(results)} videos scored in {wall:.3f} s = "
          f"{len(results) / wall:.3f} videos/s, again {wall2:.3f} s = "
          f"{len(results) / wall2:.3f} videos/s (eval B=1, T=96; {card}); "
          f"launches {launches} over {N_BATCHES} forwards", flush=True)
    scores = [s for _, s in results]
    with open(out_path) as f:
        lines = f.read().splitlines()
    if len(scores) != N_BATCHES or not all(math.isfinite(s) for s in scores):
        fail(f"scores not finite or missing: {scores}")
    if lines != [f"{n},{s}" for n, s in results]:
        fail("output.txt does not hold the scored videos")
    if launches != dict(NO_LAUNCHES, fused_swin_block=12 * N_BATCHES,
                        flash_attention_nobias_cl=9 * N_BATCHES):
        fail(f"expected 12 K1 and 9 K2 launches per forward and no other "
             f"kernel, got {launches}")
    print(f"launches per forward: K1 fused_swin_block "
          f"{launches['fused_swin_block'] // N_BATCHES}, K2 "
          f"flash_attention_nobias_cl "
          f"{launches['flash_attention_nobias_cl'] // N_BATCHES}", flush=True)

    # the same weights through the plain path (no kernel anywhere)
    plain_cfg = json.loads(json.dumps(KSVQE_CONFIG))
    plain_cfg["model"]["args"]["KSVQE"]["backbone"]["use_pallas"] = False
    plain = build_model(plain_cfg, device="cuda", state_dict=model.state_dict())
    plain_score = Evaluator(plain_cfg, model=plain, device="cuda"
                            ).inference_test(batches[:1], out_path)[0][1]
    d = abs(plain_score - scores[0])
    tol = SCORE_TOL * max(1.0, abs(plain_score))
    print(f"score kernel path {scores[0]:.6f} vs plain path "
          f"{plain_score:.6f}: |d|={d:.3g} (tol {tol:.3g})", flush=True)
    if not d <= tol:
        fail("kernel-path score disagrees with the plain path")
    t0 = time.perf_counter()
    hb = host_tensors(reshape_for_clips(pad_batch_rows(batches[0], 1),
                                        ["KSVQE"]), torch.bfloat16, pin=True)
    prep_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev_batch = {k: v.cuda() for k, v in hb.items()}
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3
    with torch.no_grad():
        feat_k, loss_k = model.KSVQE_backbone(dev_batch)
        feat_p, loss_p = plain.KSVQE_backbone(dev_batch)
    fd = (feat_k.float() - feat_p.float()).abs().max().item()
    fs = feat_p.float().abs().max().item()
    print(f"features {tuple(feat_k.shape)} kernel vs plain path: "
          f"max|d|={fd:.4g} of max|plain|={fs:.4g}; dis_loss "
          f"{float(loss_k):.6f} vs {float(loss_p):.6f}", flush=True)
    if not (math.isfinite(fd) and fd <= SCORE_TOL * max(1.0, fs)):
        fail("kernel-path features disagree with the plain path")
    del plain, feat_p

    print(f"host prep of one batch (pad, pre-cast, pinned): {prep_ms:.2f} "
          f"ms; its host-to-device copy: {h2d_ms:.2f} ms", flush=True)
    prof = forward_timings(model, dev_batch, wall / len(results) * 1e3,
                           card)
    prof.update(prep_ms=prep_ms, h2d_ms=h2d_ms)
    return {"videos_per_s": len(results) / wall,
            "videos_per_s_again": len(results) / wall2, "launches": launches,
            "scores": scores, "plain_score": plain_score, "profile": prof}


def forward_timings(model, dev_batch, video_ms: float, card: str) -> dict:
    """One eval forward on a device-resident batch: its device time (CUDA
    events), the host's dispatch, the profiler's device busy and launch
    calls, and the card's idle share of the forward and of ``video_ms``,
    the end-to-end time per scored video."""
    import torch

    def forward():
        with torch.no_grad():
            model(dev_batch, reduce_scores=True)

    fwd_ms = cuda_ms(forward, 5)
    dispatch = []  # host time to enqueue one forward (the queue never fills)
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward()
        dispatch.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    dispatch_ms = sorted(dispatch)[1]
    profile_device(forward)  # profiler warm-up
    prof = profile_device(forward)
    # idle shares against unprofiled times: the profiler's own wall time
    # carries its tracing overhead
    idle_fwd = 1.0 - prof["device_ms"] / fwd_ms
    idle_e2e = 1.0 - prof["device_ms"] / video_ms
    print(f"forward on a device-resident batch: {fwd_ms:.2f} ms; the host's "
          f"dispatch of one forward (median of 3) {dispatch_ms:.2f} ms; "
          f"profiled forward: wall {prof['wall_ms']:.2f} ms, device busy "
          f"{prof['device_ms']:.2f} ms, {prof['launch_calls']} launch calls; "
          f"idle share {idle_fwd:.3f} of the forward, {idle_e2e:.3f} of "
          f"{video_ms:.2f} ms per scored video; by family "
          f"{json.dumps(prof['families_ms'])}; host syncs "
          f"{json.dumps(prof['syncs'])}; {card}", flush=True)
    prof.update(forward_ms=fwd_ms, dispatch_ms=dispatch_ms, video_ms=video_ms,
                idle_share_forward=idle_fwd, idle_share_end_to_end=idle_e2e)
    return prof


def make_swin_batch(rng, i: int) -> dict:
    """One eval batch of the Swin-T-3D keys in the Loader's format: the
    technical view, 9x9x32 px fragments of 3 clips of 32 frames."""
    return {
        "technical": rng.standard_normal((1, T, 288, 288, 3),
                                         dtype=np.float32),
        "label": np.asarray([rng.normal()], np.float32),
        "video_name": [f"swin_{i:03d}.mp4"],
        "num_clips": [{"technical": 3}],
    }


def _score_both(config, model, dev_batch):
    """The kernel path's score and the plain path's (use_pallas off, the
    same weights) on one device-resident batch; fails past SCORE_TOL."""
    import torch

    from kvq_tpu_torch.models.vqa_network import build_model

    key = config["model"]["type"]
    plain_cfg = json.loads(json.dumps(config))
    plain_cfg["model"]["args"][key]["backbone"]["use_pallas"] = False
    plain = build_model(plain_cfg, device="cuda",
                        state_dict=model.state_dict())
    with torch.no_grad():
        sk = float(model(dev_batch, reduce_scores=True).float().mean())
        sp = float(plain(dev_batch, reduce_scores=True).float().mean())
    del plain
    torch.cuda.empty_cache()
    d, tol = abs(sk - sp), SCORE_TOL * max(1.0, abs(sp))
    print(f"{key}: score kernel path {sk:.6f} vs plain path {sp:.6f}: "
          f"|d|={d:.3g} (tol {tol:.3g})", flush=True)
    if not (math.isfinite(sk) and d <= tol):
        fail(f"{key}: kernel-path score disagrees with the plain path")
    return sk, sp


def swin_path(card: str) -> dict:
    """swin_tiny_grpb eval at full width through the evaluator (B=1,
    technical 96x288x288 as one clip): every block takes K3.  Then one
    forward of swin_tiny_grpb_m on the same input, whose (4, 4, 4) windows
    send stages 0-1 to K1 and stages 2-3 to K3, both at N=64."""
    import torch

    from kvq_tpu_torch.data.pipeline import (
        host_tensors, pad_batch_rows, reshape_for_clips)
    from kvq_tpu_torch.models.vqa_network import build_model
    from kvq_tpu_torch.train.evaluator import Evaluator

    config = swin_config("swin_tiny_grpb")
    t0 = time.time()
    model = build_model(config, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: swin_tiny_grpb + VQAHead, {n_params} parameters, bf16, "
          f"seeded random weights; built in {time.time() - t0:.1f} s",
          flush=True)
    rng = np.random.default_rng(2)
    batches = [make_swin_batch(rng, i) for i in range(N_BATCHES)]
    ev = Evaluator(config, model=model, device="cuda")
    out_path = os.path.join(tempfile.mkdtemp(prefix="kvq_smoke_"), "swin.txt")
    ev.inference_test(batches[:1], out_path)  # warm-up
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    results = ev.inference_test(batches, out_path)
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    t0 = time.perf_counter()
    ev.inference_test(batches, out_path + ".again")  # the run-to-run spread
    wall2 = time.perf_counter() - t0
    print(f"swin path: {len(results)} videos scored in {wall:.3f} s = "
          f"{len(results) / wall:.3f} videos/s, again {wall2:.3f} s = "
          f"{len(results) / wall2:.3f} videos/s (swin_tiny_grpb eval B=1, "
          f"technical 96x288x288; {card}); launches {launches} over "
          f"{N_BATCHES} forwards", flush=True)
    scores = [sc for _, sc in results]
    with open(out_path) as f:
        lines = f.read().splitlines()
    if len(scores) != N_BATCHES or not all(math.isfinite(x) for x in scores):
        fail(f"swin scores not finite or missing: {scores}")
    if lines != [f"{n},{x}" for n, x in results]:
        fail("swin output does not hold the scored videos")
    if launches != dict(NO_LAUNCHES,
                        flash_window_attention_packed=12 * N_BATCHES):
        fail(f"expected 12 K3 launches per forward and no other kernel, "
             f"got {launches}")
    print(f"launches per forward: K3 flash_window_attention_packed "
          f"{launches['flash_window_attention_packed'] // N_BATCHES}, K1 "
          f"fused_swin_block {launches['fused_swin_block']}", flush=True)

    t0 = time.perf_counter()
    hb = host_tensors(reshape_for_clips(pad_batch_rows(batches[0], 1),
                                        ["swin_tiny_grpb"]),
                      torch.bfloat16, pin=True)
    prep_ms = (time.perf_counter() - t0) * 1e3
    dev_batch = {k: v.cuda() for k, v in hb.items()}
    sk, sp = _score_both(config, model, dev_batch)
    if abs(sk - scores[0]) > SCORE_TOL * max(1.0, abs(sk)):
        fail(f"the evaluator's score {scores[0]} is not the forward's {sk}")
    print(f"host prep of one batch (pad, pre-cast, pinned): {prep_ms:.2f} ms",
          flush=True)
    prof = forward_timings(model, dev_batch, wall / len(results) * 1e3, card)
    prof.update(prep_ms=prep_ms)
    del model, ev
    torch.cuda.empty_cache()

    # swin_tiny_grpb_m: one forward, agreement and routing only
    m_config = swin_config("swin_tiny_grpb_m")
    m_model = build_model(m_config, device="cuda", seed=1)
    reset_counts()
    with torch.no_grad():
        m_model(dev_batch, reduce_scores=True)
    torch.cuda.synchronize()
    m_launches = kernel_counts()
    print(f"swin_tiny_grpb_m: launches of one forward {m_launches}",
          flush=True)
    if m_launches != dict(NO_LAUNCHES, fused_swin_block=4,
                          flash_window_attention_packed=8):
        fail(f"swin_tiny_grpb_m: expected 4 K1 and 8 K3 launches, got "
             f"{m_launches}")
    mk, mp = _score_both(m_config, m_model, dev_batch)
    del m_model
    torch.cuda.empty_cache()
    return {"videos_per_s": len(results) / wall,
            "videos_per_s_again": len(results) / wall2, "launches": launches,
            "scores": scores, "score_kernel": sk, "score_plain": sp,
            "grpb_m": {"launches": m_launches, "score_kernel": mk,
                       "score_plain": mp},
            "n_params": n_params, "profile": prof}


def make_train_batch(rng, i: int) -> dict:
    """One train batch in the Loader's format at the shipped shapes: B=4
    fragment mosaics of 32 frames (9x9x32 px), s2d-packed on the host, the
    224 px resize views, labels and distortion labels."""
    from kvq_tpu_torch.data.fragments import s2d_pack

    frags = [s2d_pack(rng.standard_normal((TRAIN_T, 288, 288, 3),
                                          dtype=np.float32))
             for _ in range(TRAIN_B)]
    return {
        "fragment": np.stack(frags),                        # (4,16,72,72,96)
        "resize_video": rng.standard_normal((TRAIN_B, TRAIN_T, 224, 224, 3),
                                            dtype=np.float32),
        "label": rng.standard_normal(TRAIN_B).astype(np.float32),
        "dis_label": np.asarray([(i + j) % 3 for j in range(TRAIN_B)],
                                np.int32),
    }


def _counted():
    """Every kernel wrapper of the port, by name."""
    from kvq_tpu_torch.ops import train_attention as TA
    from kvq_tpu_torch.ops import window_attention as WA

    return {"fused_swin_block": WA.fused_swin_block,
            "flash_attention_nobias_cl": WA.flash_attention_nobias_cl,
            "flash_window_attention_packed":
                WA.flash_window_attention_packed,
            "flash_window_attention": WA.flash_window_attention,
            "flash_attention_nobias": WA.flash_attention_nobias,
            "train_swin_block": TA.train_swin_block,
            "train_swin_block_bwd": TA.train_swin_block_bwd,
            "window_attention_train": TA.window_attention_train,
            "window_attention_train_bwd": TA.window_attention_train_bwd}


NO_LAUNCHES = {
    "fused_swin_block": 0, "flash_attention_nobias_cl": 0,
    "flash_window_attention_packed": 0, "flash_window_attention": 0,
    "flash_attention_nobias": 0, "train_swin_block": 0,
    "train_swin_block_bwd": 0, "window_attention_train": 0,
    "window_attention_train_bwd": 0,
}


def kernel_counts() -> dict:
    return {name: fn.launches for name, fn in _counted().items()}


def reset_counts() -> None:
    for fn in _counted().values():
        fn.launches = 0


def train_path(card: str) -> dict:
    """KSVQE training at full width through Trainer (B=4, T=32)."""
    import torch

    from kvq_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(1)
    batches = [make_train_batch(rng, i) for i in range(TRAIN_STEPS + 1)]
    t0 = time.time()
    tk = Trainer(TRAIN_CONFIG, device="cuda", seed=0, steps_per_epoch=100)
    n_params = sum(p.numel() for p in tk.params)
    n_train = sum(p.numel() for p in tk.params if p.requires_grad)
    print(f"train model: KSVQE + VQAHead, {n_params} parameters ({n_train} "
          f"trainable; CLIP except its adapters and CONTRIQUE frozen), f32 "
          f"masters, bf16 compute; built in {time.time() - t0:.1f} s",
          flush=True)
    ema0 = [e.clone() for e in tk.ema]

    # one kernel-path step against one plain-path step: same weights, batch
    # and generator seed, so the same QRS noise, DropPath and dropout draws
    plain_cfg = json.loads(json.dumps(TRAIN_CONFIG))
    plain_cfg["model"]["args"]["KSVQE"]["backbone"]["use_pallas"] = False
    tp = Trainer(plain_cfg, device="cuda", seed=0, steps_per_epoch=100)
    aux_k = tk.train_step(batches[0])
    aux_p = tp.train_step(batches[0])
    dl = abs(aux_k["total_loss"] - aux_p["total_loss"])
    ltol = LOSS_TOL * max(1.0, abs(aux_p["total_loss"]))
    rows, sq_d, sq_p = [], 0.0, 0.0
    for (name, pk), pp in zip(tk.model.named_parameters(), tp.params):
        if pk.grad is None:
            continue
        gk, gp = pk.grad.float(), pp.grad.float()
        d, n = (gk - gp).norm().item(), gp.norm().item()
        sq_d, sq_p = sq_d + d * d, sq_p + n * n
        rows.append((d, n, gp.numel(), name))
    total = math.sqrt(sq_d / max(sq_p, 1e-30))
    rel = sorted(((d / max(n, 1e-30), d, n, k, nm) for d, n, k, nm in rows),
                 reverse=True)
    checked = [r for r in rel if r[4].startswith("KSVQE_backbone.layers.")]
    worst, _, _, _, worst_name = checked[0]

    def show(rs):
        return [(float(f"{r:.3g}"), float(f"{d:.3g}"), float(f"{n:.3g}"), k,
                 nm) for r, d, n, k, nm in rs[:6]]

    print(f"train step, kernel path vs plain path: loss {aux_k} vs {aux_p} "
          f"(|d| {dl:.4g}, tol {ltol:.4g}); {len(rows)} gradients, all "
          f"together ||g_k - g_p|| / ||g_p|| = {total:.4g} (tol "
          f"{TRAIN_GRAD_TOL}); the {len(checked)} Swin-stage gradients, "
          f"worst (rel, |d|, |g_p|, numel, name): {show(checked)} (tol "
          f"{TRAIN_GRAD_TOL}); all gradients, worst: {show(rel)}",
          flush=True)
    if not (math.isfinite(aux_k["total_loss"]) and dl <= ltol):
        fail("kernel-path train loss disagrees with the plain path")
    if not (math.isfinite(total) and total <= TRAIN_GRAD_TOL):
        fail("kernel-path gradients disagree with the plain path")
    if not (math.isfinite(worst) and worst <= TRAIN_GRAD_TOL):
        fail(f"kernel-path gradient of {worst_name} disagrees with the "
             "plain path")
    del tp
    torch.cuda.empty_cache()

    # timed steps through train_epoch (worker-thread pre-cast, side-stream
    # copies), the counts read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    last = tk.train_epoch(batches[1:])
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = TRAIN_STEPS
    want = dict(NO_LAUNCHES, train_swin_block=10 * steps,
                train_swin_block_bwd=10 * steps,
                window_attention_train=2 * steps,
                window_attention_train_bwd=2 * steps)
    print(f"train path: {steps} steps in {wall:.3f} s = {steps / wall:.3f} "
          f"steps/s = {steps * TRAIN_B / wall:.3f} videos/s (B={TRAIN_B}, "
          f"T={TRAIN_T}); last losses {last}; launches {counts}; peak "
          f"memory {peak / 2 ** 30:.3f} GiB; {card}", flush=True)
    if counts != want:
        fail(f"expected 10 + 10 K4 and 2 + 2 K5 launches per step and no "
             f"other kernel, got {counts}")
    if not math.isfinite(last["total_loss"]):
        fail(f"train loss not finite: {last}")
    norms = torch.stack(torch._foreach_norm(tk.params))
    if not bool(torch.isfinite(norms).all()):
        fail("updated parameters are not finite")
    moved = max((e - e0).abs().max().item()
                for e, e0, p in zip(tk.ema, ema0, tk.params)
                if p.requires_grad)
    if not moved > 0:
        fail("the EMA did not move")
    print(f"updated parameters finite; EMA moved by up to {moved:.3g}",
          flush=True)
    del ema0

    # a device-resident step, timed and profiled
    _, host = tk._prepare(batches[1])
    dev = {k: v.cuda() for k, v in host.items()}
    step_ms = cuda_ms(lambda: tk._step(dev), 3)
    dispatch = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tk._step(dev)
        dispatch.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    dispatch_ms = sorted(dispatch)[1]
    profile_device(lambda: tk._step(dev))  # profiler warm-up
    prof = profile_device(lambda: tk._step(dev))
    e2e_ms = wall / steps * 1e3
    idle_step = 1.0 - prof["device_ms"] / step_ms
    idle_e2e = 1.0 - prof["device_ms"] / e2e_ms
    print(f"train step on a device-resident batch: {step_ms:.2f} ms; the "
          f"host's dispatch of one step (median of 3) {dispatch_ms:.2f} ms; "
          f"profiled step: device busy {prof['device_ms']:.2f} ms, "
          f"{prof['launch_calls']} launch calls; idle share {idle_step:.3f} "
          f"of the device-resident step, {idle_e2e:.3f} of {e2e_ms:.2f} ms "
          f"per step end to end; by family {json.dumps(prof['families_ms'])}; "
          f"host syncs {json.dumps(prof['syncs'])}; {card}", flush=True)
    prof.update(step_ms=step_ms, dispatch_ms=dispatch_ms, e2e_step_ms=e2e_ms,
                idle_share_step=idle_step, idle_share_end_to_end=idle_e2e)
    return {"steps_per_s": steps / wall, "videos_per_s": steps * TRAIN_B / wall,
            "launches": counts, "per_step": {k: v // steps for k, v in
                                             counts.items()},
            "peak_memory_bytes": peak, "loss_kernel": aux_k,
            "loss_plain": aux_p, "grad_rel_all": total,
            "swin_grads": len(checked), "grads_total": len(rows),
            "worst_swin_grad_rel": worst, "worst_swin_grad_name": worst_name,
            "worst_grads": rel[:8], "last": last, "profile": prof}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", flush=True)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available", flush=True)
        return 1
    try:
        from kvq_tpu_torch.ops import build
    except ImportError as e:
        print(f"FAIL: the kvq_tpu_torch package is not beside this script "
              f"({e})", flush=True)
        return 1
    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.time()
    reports = build.build_all()
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "ptxas.txt"), "w") as f:
        f.write("\n".join(f"[{k}]\n{v}" for k, v in reports.items()))
    gemm_sass_check()

    k1, k2 = kernel_phase(card)
    k4f, k4b, k5f, k5b = train_kernel_phase(card)
    gemm = gemm_phase(card)
    k3, k6, k7 = eval_attention_phase(card)
    run = main_path(card)
    swin = swin_path(card)
    train = train_path(card)

    def record(name, source, replaces, agg, launches, lib,
               per="the calls of one forward"):
        tb, tf = agg["bound"]
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": agg["err"], "ms": agg["ms"],
            "plain_ms": agg["plain_ms"], "bound_ms": max(tb, tf),
            "bound_by": "bytes" if tb >= tf else "operations",
            "library_ms": lib, "per": per,
        }

    step = "the calls of one train step (B=4, T=32)"
    tl = train["launches"]
    sl = swin["launches"]
    eval_src = "kvq_tpu_torch/ops/csrc/eval_attention.cu"

    kernels = [
        record("fused_swin_block", "kvq_tpu_torch/ops/csrc/swin_block.cu",
               "kvq_tpu/ops/window_attention.py:975", k1,
               run["launches"]["fused_swin_block"], None),
        record("flash_attention_nobias_cl",
               "kvq_tpu_torch/ops/csrc/nobias_attention.cu",
               "kvq_tpu/ops/window_attention.py:560", k2,
               run["launches"]["flash_attention_nobias_cl"], k2["lib_ms"]),
        record("train_swin_block", "kvq_tpu_torch/ops/csrc/swin_block.cu",
               "kvq_tpu/ops/window_attention.py:2112", k4f,
               tl["train_swin_block"], None, step),
        record("train_swin_block_bwd", "kvq_tpu_torch/ops/csrc/swin_block.cu",
               "kvq_tpu/ops/window_attention.py:1922", k4b,
               tl["train_swin_block_bwd"], None, step),
        record("window_attention_train",
               "kvq_tpu_torch/ops/csrc/train_attention.cu",
               "kvq_tpu/ops/window_attention.py:1376", k5f,
               tl["window_attention_train"], k5f["lib_ms"], step),
        record("window_attention_train_bwd",
               "kvq_tpu_torch/ops/csrc/train_attention.cu",
               "kvq_tpu/ops/window_attention.py:1416", k5b,
               tl["window_attention_train_bwd"], k5b["lib_ms"], step),
        record("flash_window_attention_packed",
               "kvq_tpu_torch/ops/csrc/swin_block.cu",
               "kvq_tpu/ops/window_attention.py:291", k3,
               sl["flash_window_attention_packed"], k3["lib_ms"],
               "the calls of one swin_tiny_grpb forward (B=1, 96x288x288)"),
        record("flash_window_attention", eval_src,
               "kvq_tpu/ops/window_attention.py:236", k6,
               sl["flash_window_attention"], k6["lib_ms"],
               "one unshifted and one shifted call at stage 0's shapes of "
               "the swin_tiny_grpb path, head-major (no model path)"),
        record("flash_attention_nobias", eval_src,
               "kvq_tpu/ops/window_attention.py:440", k7,
               run["launches"]["flash_attention_nobias"], k7["lib_ms"],
               "the nine CDM calls of one KSVQE forward, head-major (no "
               "model path)"),
    ]
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "k1_rows": k1["rows"], "k2_rows": k2["rows"],
                   "k4_fwd_rows": k4f["rows"], "k4_bwd_rows": k4b["rows"],
                   "k5_fwd_rows": k5f["rows"], "k5_bwd_rows": k5b["rows"],
                   "k3_rows": k3["rows"], "k6_rows": k6["rows"],
                   "k7_rows": k7["rows"], "gemm": gemm, "run": run,
                   "swin": swin,
                   "train": train, "kernels": kernels}, f,
                  indent=1)
    print(card, flush=True)  # name, power limit: nvidia-smi's own line
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
