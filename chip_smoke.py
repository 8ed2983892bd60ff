#!/usr/bin/env python3
"""Runs the port's main paths — KSVQE eval scoring, Swin-T-3D eval scoring
(the swin_tiny_grpb model key), KSVQE training and swin_tiny_grpb training,
then KSVQE scoring and training through the CLIs, then SimpleVQA scoring,
training and its path from mp4 files, then the data-parallel paths, then
the two-branch swin_tiny + conv_tiny model, swin_2d_tiny and the full CLIP
— on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit, the host's g++ and whether
   OpenCV's C++ headers and videoio library are there;
2. builds the CUDA kernels from ``kvq_tpu_torch/ops/csrc`` (nvcc, sm_90a)
   and, alongside, the native host runtime (``kvq_tpu_torch/runtime``,
   g++);
3. holds K1 (fused_swin_block) against its plain version at each shipped
   stage geometry and at swin_tiny_grpb_m's stages 0-1 ((4, 4, 4) windows),
   unshifted and shifted, and K2 (flash_attention_nobias_cl) at the nine
   CDM shapes (the semantic cross-attention's keys are CLIP's 7x7 patch
   tokens of the 112 px resize view), on seeded bf16 inputs;
4. holds K4 (train_swin_block, forward and backward) at the train
   geometries of stages 0-2 and K5 (window_attention_train, forward and
   backward) at stage 3's, unshifted and shifted, with DropPath
   multipliers, output and every gradient against the plain versions; K5
   again at the four padded stage geometries of swin_tiny_grpb training
   (B=4, 16x72x72 tokens padded to 77, 42, 21, 14; seam masks, the gated
   fragment bias on stages 0-2); then every product of K1 and K4 (the
   wgmma GEMM of ops/gemm.py in its forward, dX and dW layouts) at the
   shipped shapes against an f32 torch.matmul, each timed beside one
   cuBLAS call and its bound;
5. holds K3 (flash_window_attention_packed) at the four padded stage
   geometries of the Swin-T-3D path and at swin_tiny_grpb_m's padded
   stages 2-3, unshifted and shifted, K6
   (flash_window_attention) at stage 0's in head-major layout and K7
   (flash_attention_nobias) at the nine CDM shapes in head-major layout,
   against their plain versions and scaled_dot_product_attention; then
   K1 and K4 (forward and backward, B=4, DropPath multipliers) at
   swin_2d_tiny's four stage geometries (B=1, T=8, 224 px: windows of
   (1, 7, 7), N = 49; stages 0-2 unshifted and shifted, stage 3
   unshifted), output and every gradient against the plain versions;
6. builds KSVQE + VQAHead at full width from seeded random weights in bf16,
   scores a few batches of the shipped eval shapes (the 9x9x32 px mosaic of
   96 frames, the 112 px resize view) through the evaluator
   (``inference_test``), checks finite scores and 12 K1 + 9 K2 launches per
   forward, and compares the kernel path's score with the plain path's;
   then the same at config/Kwai_KSVQE_test.yml's model block as shipped
   (tuning_stage 2: 12 K1 + 6 K2 launches per forward);
7. does the same for swin_tiny_grpb + VQAHead on the technical view of the
   KVQ val config (B=1, 96x288x288 as one clip): 12 K3 launches per forward
   and no other kernel; then one forward of swin_tiny_grpb_m (4 K1 and 8 K3
   launches at N=64) against its plain path;
8. trains KSVQE at full width through ``Trainer`` (f32 masters, bf16
   compute) on seeded batches of the shipped train shapes (B=4, T=32, 112
   px resize views): one kernel-path step against one plain-path step from
   the same weights and seed (loss and every gradient), then timed steps
   that must launch K4 10 + 10 and K5 2 + 2 times each, with a finite loss,
   finite updated parameters and a moving EMA;
9. trains swin_tiny_grpb the same way on the technical view (B=4,
   32x288x288, remat on): a kernel-path step against a plain-path step,
   remat on against remat off, timed steps that must launch K5 24 + 12
   times a step (the recompute repeats the forward), a step at remat off
   (12 + 12), peak memory with remat on and off, then ``train_eval``
   (evaluate on the raw and EMA weights, the best-weights files);
10. scores 16 synthetic 1280x720 videos of 300 frames through
   ``kvq_tpu_torch.cli.test.run`` with config/Kwai_KSVQE_test.yml's val
   view (the port's KVQDataset, Loader and Evaluator): 16 finite scores in
   output.txt, 12 K1 + 9 K2 launches per forward, every item through the
   native runtime's fused views, each score within SCORE_TOL of the
   Evaluator on the same Loader's batches, then ``cli.metric_score`` on
   the prediction CSV against a truth CSV and rank pairs; holds every
   item's native views within 1e-5 of the numpy branch's; prints the
   CLI's videos/s, the Loader's alone on each branch, the host's ms per
   video by stage and the card's idle share over the run;
11. trains KSVQE through ``kvq_tpu_torch.cli.train.run`` with
   config/Kwai_KSVQE.yml's views on 8 synthetic train videos (B=4: 2 steps
   an epoch) and 4 val videos: one epoch, then one more resumed from the
   ``_last_state.pt`` it wrote; step 4 at the end, the schedule continued,
   the best-weights files, K4 10 + 10 and K5 2 + 2 launches a step, finite
   losses;
12. scores SimpleVQA at config/kwai_simpleVQA.yml's model block (bf16,
   ResNet-50 (3, 4, 6, 3) with BatchNorm, head 9472 -> 128 -> 1) from
   seeded weights, B=1, T=8 at 448x448 plus the SlowFast features, through
   ``Evaluator.inference_test``: videos/s, dispatch, device busy by family,
   launch calls, idle share and the bound from the products' FLOPs; its f32
   score on the card (TF32 off) against the CPU's, and the bf16 score's gap;
   no kernel of the port launches;
13. trains SimpleVQA at the config's settings (B=4, T=8 at 448x448, AdamW
   lr 3e-5 wd 0.05, warmup and cosine, EMA 0.999, BatchNorm in train mode)
   through ``Trainer.train_epoch``: steps/s, videos/s, dispatch, device
   busy, launches, peak memory; a finite loss, moved parameters and EMA,
   every running statistic moved once a step and float32; one f32 step on
   the card (TF32 off) against the same step on the CPU;
14. writes 8 mp4s with cv2 (300 frames, 720x1280 W x H, 30 fps), extracts
   their SlowFast features through ``cli.slowfast_features.main`` (clips/s,
   decode ms a video, SlowFast ms a clip), trains one epoch through
   ``cli.train.run`` and scores the val files through ``cli.test.run`` on
   config/kwai_simpleVQA.yml pointed at them (steps/s, videos/s, the
   Loader alone, the host's ms per video by stage with cv2's decode, the
   card's idle share);
15. runs the data-parallel paths (``kvq_tpu_torch/parallel/``): (a) KSVQE
   training as in step 8 through the Trainer's DDP route in a one-rank NCCL
   group, one step against the one-process step (loss and every gradient),
   the gradient all-reduce timed alone, timed steps with K4 10 + 10 and K5
   2 + 2 launches a step; (b) SimpleVQA training on two gloo ranks sharing
   the card (this script again with ``--rank-worker``; NCCL refuses two
   ranks on one GPU), the BatchNorms synced, in f32 with TF32 off, its
   first step against a one-process B=8 emulation (loss, running
   statistics, reduced gradients) and the ranks' parameters bit-equal after
   the timed steps; (c) KSVQE through ``cli.test.run`` on two gloo ranks
   over the 16 val mp4s of step 14: rank 0's gathered output.txt in the
   one-process order, the scores within SCORE_TOL, 12 K1 + 9 K2 launches a
   forward; (d) ``torchrun --standalone --nproc_per_node 1 -m
   kvq_tpu_torch.cli.train --ddp`` on step 11's config over 8 + 4 of those
   mp4s: its exit code, steps/s and first metrics record;
16. scores the two-branch model "swin_tiny,conv_tiny" (DOVER's technical +
   aesthetic layout, scores summed under reduce_scores) at full width in
   bf16 with use_pallas, B=1, technical and ``asesthetic`` [sic] views of
   32 frames at 224 px: K1 launches per forward (12: one per Swin block),
   videos/s over three runs, the host's dispatch, device busy by family,
   launch calls, idle share, peak memory, conv_tiny's depthwise convs timed
   alone (as the port runs them and through cuDNN's channels-last path),
   the kernel path against the plain path, conv_tiny's f32 score on the
   card (TF32 off) against the CPU's;
17. scores swin_2d_tiny + VQAHead (B=1, T=8, 224 px): 12 K1 launches a
   forward, features and score against the plain path, timings; then one
   train step through ``Trainer`` (B=4, f32 masters, bf16 compute, remat
   off) against the plain path's step (loss and every gradient), its K4
   and K5 launches by route (12 + 12 K4 where the gate fuses every block),
   three more steps and the step's timings;
18. runs the full CLIP at OpenAI's ViT-B/16 and RN50 shapes from seeded
   weights on 8 images of 224 px and 8 prompts (the tiny synthetic BPE's
   ids padded to 77): its f32 logits on the card (TF32 off) against the
   CPU's within 1e-3 of their largest, and a bf16 forward timed;
19. prints times, steps/s, videos/s, peak memory and a JSON line of kernel
   records, and as its last line ``{"ok": true, "device": {...}}``.

The videos of steps 10 and 11 are synthetic (the config's
``source_factory``), chosen by the config: the time of their frames is
not a decode time; step 14 decodes real files.  Exits non-zero without a result when CUDA is absent,
when the package is not beside this script, or when any phase fails.
Imports nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

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
# The resize view of the shipped configs (size_h/size_w 112): CLIP ViT-B/16
# encodes it as 7x7 patch tokens, the semantic cross-attention's keys.
RESIZE = 112
CLIP_TOKENS = (RESIZE // 16) ** 2
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


def keys_config(keys, use_pallas: bool = True) -> dict:
    """The model block of one or more keys (summed under reduce_scores):
    bf16, remat off, each a VQAHead on 768 channels, 64 hidden (the
    reference FAST-VQA / DOVER heads)."""
    return {"name": ",".join(keys), "model": {
        "type": ",".join(keys), "compute_dtype": "bfloat16",
        "args": {k: {
            "backbone": {"checkpoint": False, "use_pallas": use_pallas},
            "head": {"in_channels": 768, "hidden_channels": 64},
        } for k in keys},
    }}


SCHEDULE = {  # config/Kwai_KSVQE.yml's schedule, optimizer and EMA
    "num_epochs": 50, "warmup_epochs": 2.5, "ema": True, "ema_decay": 0.999,
    "batch_size": TRAIN_B,
    "optimizer": {"lr": 3e-5, "wd": 0.05, "backbone_lr_mult": 1.0},
}
TRAIN_CONFIG = {**KSVQE_CONFIG, **SCHEDULE}

# swin_tiny_grpb fine-tuned on the KVQ technical view (FAST-VQA's trunk;
# config/Kwai_KSVQE.yml's train view: 9x9 fragments of 32 px, 32 frames),
# B=4, with that schedule.  The trunk runs at 16x72x72 tokens, which no
# stage's (8, 7, 7) window divides (72, 36, 18, 9 pad to 77, 42, 21, 14):
# all 12 blocks take K5 around the plain LayerNorm/MLP, none K4.
SWIN_TRAIN_STAGES = [  # (dims after patch embed/merges, C, heads, frag)
    ((16, 72, 72), 96, 3, True),
    ((16, 36, 36), 192, 6, True),
    ((16, 18, 18), 384, 12, True),
    ((16, 9, 9), 768, 24, False),
]
SWIN_TRAIN_STEPS = 3  # timed steps after the compared ones


def swin_train_config(use_pallas: bool = True, remat: bool = True) -> dict:
    """swin_tiny_grpb's training config: remat on unless ``remat`` is
    false (JAX's default for a backbone config that says nothing)."""
    cfg = keys_config(["swin_tiny_grpb"], use_pallas)
    cfg["model"]["args"]["swin_tiny_grpb"]["backbone"]["checkpoint"] = remat
    return {**cfg, **SCHEDULE}


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
        kv = torch.randn(2, 4, CLIP_TOKENS, C, generator=gen,
                         device="cuda").to(bf)
        cases.append((f"cdm{m}.sem_cross", q, kv[0], kv[1], h, C ** -0.5))
        q = torch.randn(T // 2, hw, C, generator=gen, device="cuda").to(bf)
        kv = torch.randn(2, T // 2, 49, C, generator=gen, device="cuda").to(bf)
        cases.append((f"cdm{m}.dist_cross", q, kv[0], kv[1], h, C ** -0.5))
        qkv = torch.randn(hw, T // 2, 3 * C, generator=gen, device="cuda").to(bf)
        q, k, v = qkv.split(C, dim=-1)
        cases.append((f"cdm{m}.temporal", q, k, v, h, (C // h) ** -0.5))
    return cases


def k1_case(k1, model, stage, shifted, gen, stages, window, batch, reps,
            card):
    """K1 at one stage geometry against its plain version, timed beside it
    and its bound; adds ``reps`` x the times to the record ``k1``."""
    import torch

    from kvq_tpu_torch.ops import window_attention as WA

    args, flops, nbytes = block_case(stage, shifted, gen, stages, batch,
                                     window)
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
          f"BW={batch * geo.n_windows} N={geo.n_tokens} "
          f"C={args[0].shape[2]}: max|d|={err:.4g} "
          f"(tol {K1_TOL * scale:.4g}) kernel {ms:.4f} ms, plain "
          f"{pms:.4f} ms, bound {b:.4f} ms ({by}); {card}",
          flush=True)
    if not ok:
        fail(f"K1 {model} stage {stage} shift {geo.shift}: max|d| {err}")
    k1["ms"] += reps * ms
    k1["plain_ms"] += reps * pms
    k1["bound"][0] += reps * nbytes / PEAK_BYTES * 1e3
    k1["bound"][1] += reps * flops / PEAK_BF16_FLOPS * 1e3
    k1["err"] = max(k1["err"], err)
    k1["rows"].append((model, stage, geo.n_tokens, geo.shift, err, ms, pms,
                       b, by))


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
            k1_case(k1, model, stage, shifted, gen, stages, window, 1, reps,
                    card)
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


def k4_case(k4f, k4b, tag, stage, shifted, gen, stages, window, batch, reps,
            card):
    """K4 forward and backward at one stage geometry, with DropPath
    multipliers, against the plain versions (output and every gradient),
    timed beside them and their bounds; adds ``reps`` x the times to the
    records ``k4f``/``k4b``."""
    import torch

    from kvq_tpu_torch.ops import train_attention as TA
    from kvq_tpu_torch.ops.window_attention import fused_swin_block_plain

    (x, params, rel, frag, geo), flops, _ = block_case(
        stage, shifted, gen, stages, batch, window)
    BW, N, C = x.shape
    h, nW = geo.num_heads, geo.n_windows
    scale = geo.head_dim ** -0.5
    dp1, dp2 = _multipliers(batch, nW, gen), _multipliers(batch, nW, gen)
    dout = torch.randn(x.shape, generator=gen, device="cuda").to(
        torch.bfloat16)
    args = (x, params, rel, frag, geo, scale, dp1, dp2)
    out = TA.train_swin_block_fwd(*args)
    ref = fused_swin_block_plain(*args)
    dx, g, drel, dfrag = TA.train_swin_block_bwd(*args, dout)
    rdx, rg, rdrel, rdfrag = TA.train_swin_block_bwd_plain(*args, dout)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = K1_TOL * max(1.0, ref.float().abs().max().item())
    if not (math.isfinite(err) and err <= tol):
        fail(f"{tag} forward stage {stage} shift {geo.shift}: max|d| {err}")
    tag = f"{tag} stage{stage} shift={geo.shift}"
    gerr = {"dx": _grad_err(f"{tag} dx", dx, rdx),
            "drel": _grad_err(f"{tag} drel", drel, rdrel)}
    if frag is not None:
        gerr["dfrag"] = _grad_err(f"{tag} dfrag", dfrag, rdfrag)
    for k in g:
        gerr[k] = _grad_err(f"{tag} {k}", g[k].reshape(rg[k].shape), rg[k])
    del out, ref, dx, g, drel, dfrag, rdx, rg, rdrel, rdfrag
    ms_f = cuda_ms(lambda: TA.train_swin_block_fwd(*args), 10)
    pms_f = cuda_ms(lambda: fused_swin_block_plain(*args), 3)
    ms_b = cuda_ms(lambda: TA.train_swin_block_bwd(*args, dout), 5)
    pms_b = cuda_ms(lambda: TA.train_swin_block_bwd_plain(*args, dout), 2)
    planes = (1 + int(frag is not None)) * h * N * N * 4
    w = 12 * C * C
    by_f = 2 * BW * N * C * 2 + w * 2 + planes + 2 * BW * 4
    by_b = 3 * BW * N * C * 2 + w * 2 + w * 4 + 2 * planes + 2 * BW * 4
    bf, byf = bound_ms(by_f, flops)
    bb, byb = bound_ms(by_b, 3 * flops)
    _add(k4f, reps, ms_f, pms_f, by_f, flops, err)
    _add(k4b, reps, ms_b, pms_b, by_b, 3 * flops, max(gerr.values()))
    k4f["rows"].append((stage, geo.shift, BW, C, err, ms_f, pms_f, bf, byf))
    k4b["rows"].append((stage, geo.shift, BW, C, gerr, ms_b, pms_b, bb, byb))
    print(f"{tag} BW={BW} N={N} C={C}: forward max|d|={err:.4g} (tol "
          f"{tol:.4g}) kernel {ms_f:.4f} ms, plain {pms_f:.4f} ms, "
          f"bound {bf:.4f} ms ({byf}); backward max|d| by grad "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in gerr.items()})}"
          f" kernel {ms_b:.4f} ms, plain {pms_b:.4f} ms, bound "
          f"{bb:.4f} ms ({byb}); {card}", flush=True)
    del args, x, params, dout
    torch.cuda.empty_cache()


def train_kernel_phase(card: str, batch: int = TRAIN_B):
    """K4 at the train geometries of stages 0-2 and K5 at stage 3's (T=32,
    ``batch`` rows: the one-process step's 4, or the one row a rank of the
    (data, fsdp) step), forward and backward, against their plain
    versions; returns timing records of the calls of one train step."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    at = "" if batch == TRAIN_B else f" B={batch}"
    k4f, k4b, k5f, k5b = _agg(), _agg(), _agg(), _agg()
    for stage in range(3):
        for shifted in (False, True):
            k4_case(k4f, k4b, f"K4{at}", stage, shifted, gen, TRAIN_STAGES,
                    (8, 7, 7), batch, TRAIN_REPS[stage], card)
    dims, C, h, use_frag = TRAIN_STAGES[3]
    for shifted in (False, True):
        geo = padded_geometry(dims, C, h, use_frag, shifted, batch=batch)
        k5_case(geo, gen, card, f"K5 KSVQE stage3{at}", 1, k5f, k5b)
    return k4f, k4b, k5f, k5b


def k5_case(geo, gen, card, tag, reps, k5f, k5b):
    """K5 forward and backward at ``geo`` (seeded bf16 q, k, v, dout and
    the planes of seeded tables) against the plain versions (out, lse'd
    backward: dq, dk, dv, drel, dfrag), timed beside the plain versions
    and SDPA (the blended bias and seam mask as its float mask, backward
    into q, k, v and the mask); adds ``reps`` x the times to the records
    ``k5f``/``k5b``."""
    import torch
    import torch.nn.functional as F

    from kvq_tpu_torch.nn.swin import expand_bias_planes
    from kvq_tpu_torch.ops import train_attention as TA

    N, hd, h, nW = geo.n_tokens, geo.head_dim, geo.num_heads, geo.n_windows
    BW = geo.batch * nW
    scale = hd ** -0.5
    q, k, v, dout = (torch.randn(BW, h, N, hd, generator=gen,
                                 device="cuda").to(torch.bfloat16)
                     for _ in range(4))
    tl = math.prod(2 * w - 1 for w in (8, 7, 7))
    rel, frag = (expand_bias_planes(torch.randn(
        tl, h, generator=gen, device="cuda") * 0.5, (8, 7, 7), N)
        for _ in range(2))
    if not geo.use_frag:
        frag = None
    args = (q, k, v, rel, frag, geo, scale)
    out, lse = TA.window_attention_train_fwd(*args)
    ref = TA.window_attention_train_plain(*args)
    grads = TA.window_attention_train_bwd(*args, out, lse, dout)
    want = TA.window_attention_train_bwd_plain(*args, out, dout)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = K2_TOL * max(1.0, ref.float().abs().max().item())
    tag = f"{tag} shift={geo.shift}"
    if not (math.isfinite(err) and err <= tol):
        fail(f"{tag} forward: max|d| {err}")
    gerr = {n: _grad_err(f"{tag} {n}", a, b)
            for n, a, b in zip(("dq", "dk", "dv", "drel", "dfrag"), grads,
                               want) if b is not None}
    del ref, grads, want
    iters = max(2, min(20, int(2e7 // (BW * h * N))))
    ms_f = cuda_ms(lambda: TA.window_attention_train_fwd(*args), iters)
    pms_f = cuda_ms(lambda: TA.window_attention_train_plain(*args), 2)
    ms_b = cuda_ms(lambda: TA.window_attention_train_bwd(
        *args, out, lse, dout), iters)
    pms_b = cuda_ms(lambda: TA.window_attention_train_bwd_plain(
        *args, out, dout), 2)
    bias = (window_attn_mask(rel, frag, geo).repeat(geo.batch, 1, 1, 1)
            .requires_grad_())
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    lms_f = cuda_ms(lambda: F.scaled_dot_product_attention(
        *leaves, attn_mask=bias, scale=scale), iters)
    y = F.scaled_dot_product_attention(*leaves, attn_mask=bias, scale=scale)
    lms_b = cuda_ms(lambda: torch.autograd.grad(
        y, leaves + [bias], dout, retain_graph=True), iters)
    del y, bias, leaves
    planes = (1 + int(geo.use_frag)) * h * N * N * 4
    flops_f = 4 * BW * h * N * N * hd
    by_f = 4 * BW * h * N * hd * 2 + planes + BW * h * N * 4
    by_b = 8 * BW * h * N * hd * 2 + 2 * planes + BW * h * N * 4
    bf, byf = bound_ms(by_f, flops_f)
    bb, byb = bound_ms(by_b, 2.5 * flops_f)
    _add(k5f, reps, ms_f, pms_f, by_f, flops_f, err, lms_f)
    _add(k5b, reps, ms_b, pms_b, by_b, 2.5 * flops_f, max(gerr.values()),
         lms_b)
    k5f["rows"].append((tag, geo.dims, BW, h, err, ms_f, pms_f, lms_f, bf,
                        byf))
    k5b["rows"].append((tag, geo.dims, BW, h, gerr, ms_b, pms_b, lms_b, bb,
                        byb))
    print(f"{tag} dims={geo.dims} BW={BW} h={h} frag={geo.use_frag}: "
          f"forward max|d|={err:.4g} (tol {tol:.4g}) kernel {ms_f:.4f} ms, "
          f"plain {pms_f:.4f} ms, sdpa {lms_f:.4f} ms, bound {bf:.4f} ms "
          f"({byf}); backward max|d| by grad "
          f"{json.dumps({n: float(f'{e:.3g}') for n, e in gerr.items()})}"
          f" kernel {ms_b:.4f} ms, plain {pms_b:.4f} ms, sdpa backward "
          f"{lms_b:.4f} ms, bound {bb:.4f} ms ({byb}); {card}", flush=True)
    del args, q, k, v, dout, out, lse
    torch.cuda.empty_cache()


def swin_train_kernel_phase(card: str):
    """K5 forward and backward at the four padded geometries of
    swin_tiny_grpb training (B=4, 16x72x72 tokens), unshifted and
    shifted; the records sum the calls of one forward (12) and one
    backward (12)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    k5f, k5b = _agg(), _agg()
    for stage, (dims, C, h, use_frag) in enumerate(SWIN_TRAIN_STAGES):
        for shifted in (False, True):
            geo = padded_geometry(dims, C, h, use_frag, shifted,
                                  batch=TRAIN_B)
            k5_case(geo, gen, card, f"K5 swin_tiny_grpb stage{stage}",
                    SWIN_REPS[stage], k5f, k5b)
    return k5f, k5b


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


def padded_geometry(dims, C, h, use_frag, shifted, window=(8, 7, 7),
                    batch=1):
    """The geometry K3 (eval) or K5 (training) runs at for a block over
    ``dims`` tokens: the window and shift after clamping, the dims padded
    to whole windows."""
    from kvq_tpu_torch.nn.swin import get_window_size
    from kvq_tpu_torch.ops.window_attention import WindowGeometry

    cfg_shift = tuple(w // 2 for w in window) if shifted else (0, 0, 0)
    win, shift = get_window_size(dims, window, cfg_shift)
    padded = tuple(d + (w - d % w) % w for d, w in zip(dims, win))
    return WindowGeometry(batch=batch, dims=padded, window=win, shift=shift,
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
    112 px resize view."""
    from kvq_tpu_torch.data.fragments import s2d_pack

    mosaic = rng.standard_normal((T, 288, 288, 3), dtype=np.float32)
    return {
        "fragment": s2d_pack(mosaic)[None],                 # (1,48,72,72,96)
        "resize_video": rng.standard_normal((1, T, RESIZE, RESIZE, 3),
                                            dtype=np.float32),
        "label": np.asarray([rng.normal()], np.float32),
        "dis_label": np.asarray([i % 4], np.int32),
        "video_name": [f"smoke_{i:03d}.mp4"],
        "num_clips": [{"technical": 3}],
    }


FAMILIES = ("kvq_window_attention", "kvq_attention_bwd", "kvq_gemm",
            "kvq_layernorm", "kvq_train_other", "kvq_nobias_attention",
            "conv (cuDNN)", "matmul (cuBLAS)", "nccl", "other")


def _family(name: str) -> str:
    low = name.lower()
    if "nccl" in low:  # the collectives' kernels
        return "nccl"
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


def profile_device(fn, family=None) -> dict:
    """Device time by kernel family (``family``: kernel name -> family, by
    default ``_family``) over one call of ``fn`` (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    top = []
    fam = {k: 0.0 for k in (FAMILIES if family is None else ())}
    family = family or _family
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
        name = family(evt.key)
        fam[name] = fam.get(name, 0.0) + us / 1e3
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


TS2_BATCHES = 4  # scored batches of the tuning_stage 2 run


def tuning_stage_2_path(card: str) -> dict:
    """KSVQE scoring at config/Kwai_KSVQE_test.yml's model block as shipped
    (tuning_stage 2: the CDM modulates stages 2-3 only), seeded weights in
    place of its ``your_checkpoint``: 12 K1 + 6 K2 launches per forward,
    finite scores, and the kernel path's score against the plain path's."""
    import torch

    from kvq_tpu_torch.core.config import load_config
    from kvq_tpu_torch.models.vqa_network import build_model
    from kvq_tpu_torch.train.evaluator import Evaluator

    shipped = load_config(os.path.join(ROOT, "config",
                                       "Kwai_KSVQE_test.yml"))
    config = {"name": shipped["name"], "model": shipped["model"]}
    bb = config["model"]["args"]["KSVQE"]["backbone"]
    if (bb["tuning_stage"], bb["a2"], bb["use_pallas"]) != (2, 2, True):
        fail(f"config/Kwai_KSVQE_test.yml no longer ships tuning_stage 2: "
             f"{bb}")
    model = build_model(config, device="cuda", seed=0)
    rng = np.random.default_rng(5)
    batches = [make_batch(rng, i) for i in range(TS2_BATCHES)]
    ev = Evaluator(config, model=model, device="cuda")
    out_path = os.path.join(tempfile.mkdtemp(prefix="kvq_ts2_"), "output.txt")
    ev.inference_test(batches[:1], out_path)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    results = ev.inference_test(batches, out_path)
    wall = time.perf_counter() - t0
    launches = kernel_counts()
    scores = [s for _, s in results]
    if not all(map(math.isfinite, scores)) or len(scores) != TS2_BATCHES:
        fail(f"tuning_stage 2: scores {scores}")
    if launches != dict(NO_LAUNCHES, fused_swin_block=12 * TS2_BATCHES,
                        flash_attention_nobias_cl=6 * TS2_BATCHES):
        fail(f"tuning_stage 2: expected 12 K1 and 6 K2 launches per forward "
             f"and no other kernel, got {launches}")
    plain_cfg = json.loads(json.dumps(config))
    plain_cfg["model"]["args"]["KSVQE"]["backbone"]["use_pallas"] = False
    plain = build_model(plain_cfg, device="cuda",
                        state_dict=model.state_dict())
    plain_score = Evaluator(plain_cfg, model=plain, device="cuda"
                            ).inference_test(batches[:1], out_path)[0][1]
    d = abs(plain_score - scores[0])
    tol = SCORE_TOL * max(1.0, abs(plain_score))
    print(f"tuning_stage 2 (config/Kwai_KSVQE_test.yml's model): "
          f"{TS2_BATCHES} videos in {wall:.3f} s = {TS2_BATCHES / wall:.3f} "
          f"videos/s (B=1, T=96); launches per forward: K1 "
          f"{launches['fused_swin_block'] // TS2_BATCHES}, K2 "
          f"{launches['flash_attention_nobias_cl'] // TS2_BATCHES}; score "
          f"kernel path {scores[0]:.6f} vs plain path {plain_score:.6f}: "
          f"|d|={d:.3g} (tol {tol:.3g}); {card}", flush=True)
    if not d <= tol:
        fail("tuning_stage 2: kernel-path score disagrees with the plain "
             "path")
    del model, plain, ev
    torch.cuda.empty_cache()
    return {"videos_per_s": TS2_BATCHES / wall, "launches": launches,
            "scores": scores, "plain_score": plain_score,
            "max_abs_score_diff": d}


def forward_timings(model, dev_batch, video_ms: float, card: str,
                    family=None) -> dict:
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
    profile_device(forward, family)  # profiler warm-up
    prof = profile_device(forward, family)
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
    """The kernel path's score and the plain path's (every backbone's
    use_pallas off, the same weights) on one device-resident batch; fails
    past SCORE_TOL."""
    import torch

    from kvq_tpu_torch.models.vqa_network import build_model

    key = config["model"]["type"]
    plain_cfg = json.loads(json.dumps(config))
    for hypers in plain_cfg["model"]["args"].values():
        hypers["backbone"]["use_pallas"] = False
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

    config = keys_config(["swin_tiny_grpb"])
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
    m_config = keys_config(["swin_tiny_grpb_m"])
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
    112 px resize views, labels and distortion labels."""
    from kvq_tpu_torch.data.fragments import s2d_pack

    frags = [s2d_pack(rng.standard_normal((TRAIN_T, 288, 288, 3),
                                          dtype=np.float32))
             for _ in range(TRAIN_B)]
    return {
        "fragment": np.stack(frags),                        # (4,16,72,72,96)
        "resize_video": rng.standard_normal(
            (TRAIN_B, TRAIN_T, RESIZE, RESIZE, 3), dtype=np.float32),
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


def step_agreement(what, ta, tb, aux_a, aux_b, checked_prefix) -> dict:
    """One train step of trainer ``ta`` against the same step of ``tb``
    (same weights, batch and generator seed): :func:`grad_agreement` of
    their gradients."""
    grads = [{n: p.grad for n, p in t.model.named_parameters()
              if p.grad is not None} for t in (ta, tb)]
    return grad_agreement(what, *grads, aux_a, aux_b, checked_prefix)


def grad_agreement(what, grads_a, grads_b, aux_a, aux_b,
                   checked_prefix) -> dict:
    """One train step's loss terms and gradients (name -> tensor) against
    another's: the loss within LOSS_TOL, all gradients together and each
    gradient whose name starts with ``checked_prefix`` (the Swin stages,
    whose gradients the kernels produce) within TRAIN_GRAD_TOL of its norm;
    prints (:func:`grad_gaps`) and fails."""
    gaps = grad_gaps(what, grads_a, grads_b, aux_a, aux_b, checked_prefix)
    if not (math.isfinite(aux_a["total_loss"])
            and gaps["loss_abs_diff"] <= gaps["loss_tol"]):
        fail(f"{what}: the losses disagree")
    if not (math.isfinite(gaps["grad_rel_all"])
            and gaps["grad_rel_all"] <= TRAIN_GRAD_TOL):
        fail(f"{what}: the gradients disagree")
    worst = gaps["worst_swin_grad_rel"]
    if not (math.isfinite(worst) and worst <= TRAIN_GRAD_TOL):
        fail(f"{what}: the gradient of {gaps['worst_swin_grad_name']} "
             f"disagrees")
    return gaps


def grad_gaps(what, grads_a, grads_b, aux_a, aux_b, checked_prefix) -> dict:
    """The gaps of one train step's loss terms and gradients to another's:
    the loss's |d| (and its tolerance), all gradients together and each
    gradient relative to its norm, the worst of those whose name starts
    with ``checked_prefix``; prints them."""
    import torch

    dl = abs(aux_a["total_loss"] - aux_b["total_loss"])
    ltol = LOSS_TOL * max(1.0, abs(aux_b["total_loss"]))
    if not set(grads_b) <= set(grads_a):
        fail(f"{what}: gradients of different parameters")
    rows, sq_d, sq_p = [], 0.0, 0.0
    for name, ga in grads_a.items():  # a gradient b lacks counts as zeros
        ga = ga.float()
        gb = grads_b[name].float().to(ga.device) if name in grads_b else \
            torch.zeros_like(ga)
        d, n = (ga - gb).norm().item(), gb.norm().item()
        sq_d, sq_p = sq_d + d * d, sq_p + n * n
        rows.append((d, n, gb.numel(), name))
    total = math.sqrt(sq_d / max(sq_p, 1e-30))
    rel = sorted(((d / max(n, 1e-30), d, n, k, nm) for d, n, k, nm in rows),
                 reverse=True)
    checked = [r for r in rel if r[4].startswith(checked_prefix)]
    worst, _, _, _, worst_name = checked[0]
    median = checked[len(checked) // 2][0]

    def show(rs):
        return [(float(f"{r:.3g}"), float(f"{d:.3g}"), float(f"{n:.3g}"), k,
                 nm) for r, d, n, k, nm in rs[:6]]

    print(f"{what}: loss {aux_a} vs {aux_b} (|d| {dl:.4g}, tol {ltol:.4g}); "
          f"{len(rows)} gradients, all together ||g_a - g_b|| / ||g_b|| = "
          f"{total:.4g} (tol {TRAIN_GRAD_TOL}); the {len(checked)} "
          f"Swin-stage gradients, worst (rel, |d|, |g_b|, numel, name): "
          f"{show(checked)}, median {median:.3g}; all gradients, worst: "
          f"{show(rel)}", flush=True)
    return {"loss_a": aux_a, "loss_b": aux_b, "loss_abs_diff": dl,
            "loss_tol": ltol,
            "grad_rel_all": total, "swin_grads": len(checked),
            "grads_total": len(rows), "worst_swin_grad_rel": worst,
            "median_swin_grad_rel": median,
            "worst_swin_grad_name": worst_name, "worst_grads": rel[:8]}


def step_timings(tr, batch, e2e_ms: float, card: str, family=None) -> dict:
    """One train step of ``tr`` on a device-resident batch: its time (CUDA
    events), the host's dispatch, the profiler's device busy, launch calls
    and families, and the card's idle share of the step and of ``e2e_ms``,
    the end-to-end time per step."""
    import torch

    _, host = tr._prepare(batch)
    dev = {k: v.cuda() for k, v in host.items()}
    step_ms = cuda_ms(lambda: tr._step(dev), 3)
    dispatch = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr._step(dev)
        dispatch.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    dispatch_ms = sorted(dispatch)[1]
    profile_device(lambda: tr._step(dev), family)  # profiler warm-up
    prof = profile_device(lambda: tr._step(dev), family)
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
    return prof


def check_trained(tr, ema0, last) -> None:
    """A finite loss, finite updated parameters and an EMA that moved from
    ``ema0``; fails otherwise."""
    import torch

    if not math.isfinite(last["total_loss"]):
        fail(f"train loss not finite: {last}")
    norms = torch.stack(torch._foreach_norm(tr.params))
    if not bool(torch.isfinite(norms).all()):
        fail("updated parameters are not finite")
    moved = max((e - e0).abs().max().item()
                for e, e0, p in zip(tr.ema, ema0, tr.params)
                if p.requires_grad)
    if not moved > 0:
        fail("the EMA did not move")
    print(f"updated parameters finite; EMA moved by up to {moved:.3g}",
          flush=True)


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
    agree = step_agreement("train step, kernel path vs plain path", tk, tp,
                           aux_k, aux_p, "KSVQE_backbone.layers.")
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
    check_trained(tk, ema0, last)
    del ema0

    prof = step_timings(tk, batches[1], wall / steps * 1e3, card)
    return {"steps_per_s": steps / wall, "videos_per_s": steps * TRAIN_B / wall,
            "launches": counts, "per_step": {k: v // steps for k, v in
                                             counts.items()},
            "peak_memory_bytes": peak, "agreement": agree, "last": last,
            "profile": prof}


def make_swin_train_batch(rng) -> dict:
    """One swin_tiny_grpb train batch in the Loader's format: B=4 technical
    views of 32 frames (9x9x32 px fragments) and their labels."""
    return {
        "technical": rng.standard_normal((TRAIN_B, TRAIN_T, 288, 288, 3),
                                         dtype=np.float32),
        "label": rng.standard_normal(TRAIN_B).astype(np.float32),
    }


def _set_remat(tr, on: bool) -> None:
    """Remat on or off in every stage of a built trainer's trunk (the flag
    ``checkpoint`` of the backbone config sets at construction)."""
    for stage in tr.model.swin_tiny_grpb_backbone.layers:
        stage.use_checkpoint = on


def _step_peak(tr, batch) -> tuple[float, int]:
    """One train step; (peak device bytes during it, bytes resident before
    it)."""
    import torch

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tr.train_step(batch)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated(), resident


def swin_train_path(card: str) -> dict:
    """swin_tiny_grpb training at full width through Trainer (B=4, technical
    32x288x288, remat on as JAX's default): agreement with the plain path
    and of remat on with remat off, timed steps through train_epoch, peak
    memory with remat on and off, K5's launches, then train_eval (evaluate
    on the raw and EMA weights, best-weights files)."""
    import gc

    import torch

    from kvq_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(4)
    batches = [make_swin_train_batch(rng) for _ in range(SWIN_TRAIN_STEPS + 2)]
    prefix = "swin_tiny_grpb_backbone.layers."

    def trainer(use_pallas, remat):
        return Trainer(swin_train_config(use_pallas, remat), device="cuda",
                       seed=0, steps_per_epoch=100)

    # 1. one kernel-path step against one plain-path step (the plain path
    # materialises every window's scores: 1.8 GB a tensor at stage 0), at
    # remat off, or at remat on if remat off does not fit
    for remat in (False, True):
        tp = None
        try:
            tp = trainer(False, remat)
            aux_p = tp.train_step(batches[0])
            break
        except torch.cuda.OutOfMemoryError as e:
            print(f"plain-path step at remat {remat}: out of memory ({e}); "
                  "comparing at remat on", flush=True)
            del tp
            gc.collect()
            torch.cuda.empty_cache()
    else:
        fail("the plain-path step does not fit at remat on either")
    t0 = time.time()
    tk = trainer(True, remat)
    n_params = sum(p.numel() for p in tk.params)
    print(f"swin train model: swin_tiny_grpb + VQAHead, {n_params} "
          f"parameters, all trainable, f32 masters, bf16 compute, remat "
          f"{remat} for the agreement; built in {time.time() - t0:.1f} s",
          flush=True)
    aux_k = tk.train_step(batches[0])
    agree = step_agreement(
        f"swin_tiny_grpb train step at remat {remat}, kernel path vs plain "
        "path", tk, tp, aux_k, aux_p, prefix)
    del tp
    gc.collect()
    torch.cuda.empty_cache()

    # 2. remat on against remat off on the kernel path
    to = trainer(True, not remat)
    aux_o = to.train_step(batches[0])
    on, off = (to, tk) if remat is False else (tk, to)
    aux_on, aux_off = (aux_o, aux_k) if remat is False else (aux_k, aux_o)
    agree_remat = step_agreement(
        "swin_tiny_grpb train step, kernel path, remat on vs remat off", on,
        off, aux_on, aux_off, prefix)
    del to, on, off
    gc.collect()
    torch.cuda.empty_cache()

    # 3. timed steps through train_epoch with remat on, the counts read
    # just after; then one step with remat off counted on its own, and
    # each one's peak memory with this trainer alone on the card
    _set_remat(tk, True)
    ema0 = [e.clone() for e in tk.ema]
    peak_on, resident = _step_peak(tk, batches[1])  # also the warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    last = tk.train_epoch(batches[2:2 + SWIN_TRAIN_STEPS])
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    peak_epoch = torch.cuda.max_memory_allocated()
    steps = SWIN_TRAIN_STEPS
    print(f"swin train path: {steps} steps in {wall:.3f} s = "
          f"{steps / wall:.3f} steps/s = {steps * TRAIN_B / wall:.3f} "
          f"videos/s (swin_tiny_grpb, B={TRAIN_B}, technical "
          f"{TRAIN_T}x288x288, remat on); last losses {last}; launches "
          f"{counts}; {card}", flush=True)
    # remat runs each block's forward again in the backward: K5's forward
    # launches twice a block and a step (12 in the forward, 12 in the
    # recompute), its backward once
    if counts != dict(NO_LAUNCHES, window_attention_train=24 * steps,
                      window_attention_train_bwd=12 * steps):
        fail(f"expected 24 + 12 K5 launches per step (remat on) and no "
             f"other kernel, got {counts}")
    check_trained(tk, ema0, last)
    del ema0
    _set_remat(tk, False)
    reset_counts()
    peak_off, _ = _step_peak(tk, batches[1])
    counts_off = kernel_counts()
    _set_remat(tk, True)
    print(f"swin train path: one step at remat off: launches {counts_off}",
          flush=True)
    if counts_off != dict(NO_LAUNCHES, window_attention_train=12,
                          window_attention_train_bwd=12):
        fail(f"expected 12 + 12 K5 launches in a step at remat off, got "
             f"{counts_off}")
    print(f"swin train peak memory: remat on {peak_on / 2 ** 30:.3f} GiB "
          f"(over the timed steps {peak_epoch / 2 ** 30:.3f}), remat off "
          f"{peak_off / 2 ** 30:.3f} GiB, of which the trainer's resident "
          f"state {resident / 2 ** 30:.3f} GiB; {card}", flush=True)

    # 4. the device-resident step, timed and profiled
    prof = step_timings(tk, batches[1], wall / steps * 1e3, card)

    # 5. train_eval: one more epoch, then evaluate with the raw and the
    # EMA weights (the eval path: K3) and write the best weights
    val = [{"technical": b["technical"][i:i + 1], "label": b["label"][i:i + 1],
            "video_name": [f"val_{j}_{i}"]}
           for j, b in enumerate(batches[:2]) for i in range(TRAIN_B)]
    tk.workdir = tempfile.mkdtemp(prefix="kvq_smoke_")
    best, best_ema = tk.train_eval(batches[1:2], val)
    files = sorted(os.listdir(tk.workdir))
    shutil.rmtree(tk.workdir)
    print(f"swin train_eval over {len(val)} videos: best (SRCC, PLCC, KRCC, "
          f"RMSE) {best}, best EMA {best_ema}; files {files}", flush=True)
    if not (all(math.isfinite(x) for x in best + best_ema) and files == [
            "swin_tiny_grpb_head_val_n_finetuned.pth",
            "swin_tiny_grpb_head_val_s_finetuned.pth"]):
        fail("train_eval did not evaluate or did not keep the best weights")
    return {"steps_per_s": steps / wall, "videos_per_s": steps * TRAIN_B / wall,
            "launches": counts, "per_step": {k: v // steps for k, v in
                                             counts.items()},
            "launches_remat_off_step": counts_off,
            "peak_memory_bytes_remat_on": peak_on,
            "peak_memory_bytes_remat_on_timed": peak_epoch,
            "peak_memory_bytes_remat_off": peak_off,
            "resident_bytes": resident, "agreement_remat": remat,
            "agreement": agree, "agreement_remat_on_off": agree_remat,
            "last": last, "best": best, "best_ema": best_ema,
            "n_params": n_params, "profile": prof}


# config/Kwai_KSVQE_test.yml's val view and config/Kwai_KSVQE.yml's train
# view (9x9 fragments of 32 px, the 112 px resize view, 32-frame clips)
VAL_VIEW = {"fragments_h": 9, "fragments_w": 9, "fsize_h": 32, "fsize_w": 32,
            "size_h": RESIZE, "size_w": RESIZE, "aligned": 8, "clip_len": 32,
            "frame_interval": 4, "num_clips": 3}
TRAIN_VIEW = dict(VAL_VIEW, num_clips=1)
# synthetic videos of the CLI phases: portrait short-form frames (H x W)
CLI_FRAMES, CLI_H, CLI_W = 300, 1280, 720
CLI_VIDEOS = 16                  # scored through cli.test
CLI_TRAIN_VIDEOS, CLI_VAL_VIDEOS = 8, 4  # trained / validated by cli.train


class SyntheticVideos:
    """A dataset's ``source_factory``: the file name's synthetic 1280x720
    video (seeded by the name's crc32), noting when it was first asked
    for."""

    def __init__(self):
        self.first = None

    def __deepcopy__(self, memo):  # the config's copies share the factory
        return self

    def __call__(self, path):
        from kvq_tpu_torch.data.decode import SyntheticVideoSource

        if self.first is None:
            self.first = time.perf_counter()
        name = os.path.basename(path)
        return SyntheticVideoSource(CLI_FRAMES, CLI_H, CLI_W,
                                    seed=zlib.crc32(name.encode()) % 2 ** 31)


def write_split(root, split, n, rng) -> list[tuple[str, float]]:
    """A 4-column annotation TXT (``filename,cls_label,dis_label,score``)
    of ``n`` videos under ``root``; returns (name, score)."""
    rows = [(f"{split}_{i:02d}.mp4", float(rng.uniform(1, 5)))
            for i in range(n)]
    with open(os.path.join(root, f"{split}.txt"), "w") as f:
        f.writelines(f"{name},{i % 3},{i % 4},{score}\n"
                     for i, (name, score) in enumerate(rows))
    return rows


def kvq_split(root, split, phase, view, factory) -> dict:
    return {"type": "ViewDecompositionDataset_KVQ", "args": {
        "phase": phase, "anno_file": os.path.join(root, f"{split}.txt"),
        "data_prefix": root, "sample_types": {"technical": dict(view)},
        "source_factory": factory}}


def loader_split(dataset, n: int = 2) -> dict:
    """The host's ms per video of ``dataset`` (a KVQDataset), by stage, over
    ``n`` videos: the synthetic source's frames, the numpy branch's mosaic,
    resize view and two normalisations, the native branch's fused views
    (the same work in C++) on one thread and on the runtime's four, the s2d
    pack and the collate; one thread unless said."""
    from kvq_tpu_torch import runtime
    from kvq_tpu_torch.data import views as V
    from kvq_tpu_torch.data.datasets import _filter_view_opts, _native_views
    from kvq_tpu_torch.data.decode import decode_views
    from kvq_tpu_torch.data.fragments import fragment_index_maps, s2d_pack
    from kvq_tpu_torch.data.pipeline import collate

    def native_one_thread(raw, sopt, rng):
        T, H, W = raw.shape[:3]
        maps = fragment_index_maps(H, W, T, sopt["fragments_h"],
                                   sopt["fragments_w"], sopt["fsize_h"],
                                   sopt["fsize_w"], sopt["aligned"], rng=rng)
        runtime.fragment_mosaic_normalize(raw, *maps, sopt["aligned"],
                                          V.IMAGENET_255_MEAN,
                                          V.IMAGENET_255_STD, n_threads=1)
        runtime.resize_normalize(raw, sopt["size_h"], sopt["size_w"],
                                 V.CLIP_MEAN, V.CLIP_STD, True, n_threads=1)

    ms = dict.fromkeys(("synthetic frames", "mosaic", "resize", "normalise",
                        "native views", "native views (4 threads)",
                        "s2d pack", "collate"), 0.0)

    def timed(stage, fn, *a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        ms[stage] += (time.perf_counter() - t0) * 1e3 / n
        return out

    for i in range(n):
        rng = dataset._rng(i)
        source = dataset.source_factory(dataset.video_infos[i]["filename"])
        videos, _ = timed("synthetic frames", decode_views, source,
                          dataset._samplers(rng))
        raw = videos["technical"]
        sopt = _filter_view_opts(dataset.sample_types["technical"])
        if i == 0 and not np.array_equal(
                runtime.resize(raw, sopt["size_h"], sopt["size_w"]),
                V.get_resized_video(raw, **sopt)):
            fail("the native resize's uint8 frames differ from "
                 "data/resize.py's on this host")
        timed("native views", native_one_thread, raw, sopt,
              dataset._rng(i))
        timed("native views (4 threads)", _native_views, raw, sopt,
              dataset._rng(i))
        frag = timed("mosaic", V.get_single_view, raw, "technical", rng=rng,
                     **sopt)
        res = timed("resize", V.get_resized_video, raw, **sopt)
        frag = timed("normalise", V.normalize, frag, "imagenet_255")
        res = timed("normalise", V.normalize, res, "clip")
        frag = timed("s2d pack", s2d_pack, frag)
        timed("collate", collate, [{"fragment": frag, "resize_video": res,
                                    "label": 1.0, "video_name": "v"}])
    return ms


def cli_eval_path(card: str) -> dict:
    """KSVQE scoring through ``kvq_tpu_torch.cli.test.run`` (dataset ->
    Loader -> Evaluator -> output.txt) on synthetic videos."""
    import torch

    from kvq_tpu_torch.cli import metric_score as cli_metric
    from kvq_tpu_torch.cli import test as cli_test
    from kvq_tpu_torch.data import datasets as PD
    from kvq_tpu_torch.data.pipeline import build_loaders
    from kvq_tpu_torch.train.evaluator import Evaluator

    print(f"cli eval: {CLI_VIDEOS} synthetic {CLI_H}x{CLI_W} videos of "
          f"{CLI_FRAMES} frames (SyntheticVideoSource, chosen by the "
          f"config's source_factory: no file is decoded)", flush=True)
    root = tempfile.mkdtemp(prefix="kvq_cli_eval_")
    rows = write_split(root, "val", CLI_VIDEOS, np.random.default_rng(2))
    factory = SyntheticVideos()
    config = {**KSVQE_CONFIG, "num_workers": 6, "data": {
        "val": kvq_split(root, "val", "test", VAL_VIEW, factory)}}

    # the Loader alone, on the native branch and on the numpy branch (the
    # one before the native runtime), then the Evaluator on the native
    # branch's batches
    _, loader = build_loaders(config)
    t0 = time.perf_counter()
    batches = list(loader.epoch(0))
    loader_s = time.perf_counter() - t0
    PD.NATIVE = False
    try:
        t0 = time.perf_counter()
        numpy_batches = list(loader.epoch(0))
        numpy_loader_s = time.perf_counter() - t0
    finally:
        PD.NATIVE = True
    item_d = {k: max(float(np.abs(a[k] - b[k]).max())
                     for a, b in zip(batches, numpy_batches))
              for k in ("fragment", "resize_video")}
    print(f"native against numpy branch, every item of the split: max|d| "
          f"{json.dumps(item_d)} (tolerance 1e-5: the same uint8 pixels, "
          f"normalised in another f32 order; the uint8 resize of one video "
          f"is checked equal below)", flush=True)
    if not max(item_d.values()) <= 1e-5:
        fail("the native branch's views disagree with the numpy branch's")
    del numpy_batches
    split_ms = loader_split(loader.dataset)
    ev = Evaluator(config, device="cuda")
    want = dict(ev.inference_test(batches, os.path.join(root, "ref.txt")))
    del ev, batches
    torch.cuda.empty_cache()

    out, csv = os.path.join(root, "output.txt"), os.path.join(root, "pred.csv")
    native_views = PD._native_views
    taken = []
    PD._native_views = lambda *a: taken.append(1) or native_views(*a)
    try:
        reset_counts()
        factory.first = None
        results = cli_test.run(config, out, csv)
        end = time.perf_counter()
        counts = kernel_counts()
    finally:
        PD._native_views = native_views
    if len(taken) != CLI_VIDEOS:
        fail(f"cli.test: {len(taken)} items took the native branch, "
             f"expected {CLI_VIDEOS}")
    e2e_s = end - factory.first
    factory.first = None
    prof = profile_device(lambda: cli_test.run(config, out + ".profiled"))
    idle = 1.0 - prof["device_ms"] / (e2e_s * 1e3)

    with open(out) as f:
        lines = f.read().splitlines()
    scores = [s for _, s in results]
    if (len(lines) != CLI_VIDEOS or [n for n, _ in results]
            != [n for n, _ in rows] or not all(map(math.isfinite, scores))):
        fail(f"cli.test wrote {len(lines)} lines, scores {scores}")
    if lines != [f"{n},{s}" for n, s in results]:
        fail("output.txt does not hold the scored videos")
    if counts != dict(NO_LAUNCHES, fused_swin_block=12 * CLI_VIDEOS,
                      flash_attention_nobias_cl=9 * CLI_VIDEOS):
        fail(f"cli.test: expected 12 K1 and 9 K2 launches per forward and "
             f"no other kernel, got {counts}")
    diffs = [abs(s - want[n]) for n, s in results]
    worst = max(d / (SCORE_TOL * max(1.0, abs(want[n])))
                for d, (n, _) in zip(diffs, results))
    print(f"cli.test.run: {CLI_VIDEOS} videos scored in {e2e_s:.3f} s from "
          f"the first item to the file written = {CLI_VIDEOS / e2e_s:.3f} "
          f"videos/s; launches {counts}; scores against the Evaluator on the "
          f"same Loader's batches: max|d| {max(diffs):.4g} (tol SCORE_TOL "
          f"{SCORE_TOL} x max(1, |score|)); device busy over a profiled run "
          f"{prof['device_ms']:.2f} ms, idle share {idle:.3f} of the "
          f"unprofiled run; {card}", flush=True)
    if not worst <= 1.0:
        fail("cli.test's scores disagree with the Evaluator's")
    print(f"the Loader alone ({loader.num_workers} threads): {CLI_VIDEOS} "
          f"videos in {loader_s:.3f} s = {CLI_VIDEOS / loader_s:.3f} "
          f"videos/s on the native branch, {numpy_loader_s:.3f} s = "
          f"{CLI_VIDEOS / numpy_loader_s:.3f} videos/s on the numpy branch; "
          f"host ms per video by stage: "
          f"{json.dumps({k: round(v, 2) for k, v in split_ms.items()})} "
          f"(synthetic frames are generated, not decoded); {card}",
          flush=True)

    truth = os.path.join(root, "truth.csv")
    with open(truth, "w") as f:
        f.write("filename,score\n")
        f.writelines(f"{n},{s}\n" for n, s in rows)
    pairs = os.path.join(root, "pairs")
    os.makedirs(pairs)
    order = sorted(rows, key=lambda r: -r[1])
    for sheet, step in (("nonsource", 3), ("source", 5)):
        with open(os.path.join(pairs, f"{sheet}.csv"), "w") as f:
            f.write("better,worse\n")
            f.writelines(f"{order[i][0]},{order[i + step][0]}\n"
                         for i in range(0, CLI_VIDEOS - step, 2))
    res = cli_metric.main(["--pred", csv, "--truth", truth, "--rank_pairs",
                           pairs])
    formula = (0.45 * res["srcc"] + 0.45 * res["plcc"]
               + 0.05 * res["acc_nonsource"] + 0.05 * res["acc_source"])
    if not (all(map(math.isfinite, res.values()))
            and abs(res["score"] - formula) <= 1e-12):
        fail(f"cli.metric_score: {res}")
    shutil.rmtree(root)
    return {"videos_per_s": CLI_VIDEOS / e2e_s, "e2e_s": e2e_s,
            "loader_videos_per_s": CLI_VIDEOS / loader_s,
            "numpy_loader_videos_per_s": CLI_VIDEOS / numpy_loader_s,
            "native_vs_numpy_max_abs": item_d,
            "host_ms_per_video": split_ms, "launches": counts,
            "max_abs_score_diff": max(diffs), "device_busy_ms":
            prof["device_ms"], "idle_share": idle,
            "launch_calls": prof["launch_calls"], "metric_score": res}


def cli_train_path(card: str) -> dict:
    """KSVQE training through ``kvq_tpu_torch.cli.train.run`` on synthetic
    videos: one epoch, then one more resumed from its ``_last_state.pt``."""
    import torch

    from kvq_tpu_torch.cli import train as cli_train
    from kvq_tpu_torch.train.optim import schedule_factor
    from kvq_tpu_torch.train.trainer import Trainer

    print(f"cli train: {CLI_TRAIN_VIDEOS} + {CLI_VAL_VIDEOS} synthetic "
          f"{CLI_H}x{CLI_W} videos of {CLI_FRAMES} frames (SyntheticVideoSource, "
          f"chosen by the config's source_factory: no file is decoded)",
          flush=True)
    root = tempfile.mkdtemp(prefix="kvq_cli_train_")
    rng = np.random.default_rng(3)
    write_split(root, "train", CLI_TRAIN_VIDEOS, rng)
    write_split(root, "val", CLI_VAL_VIDEOS, rng)
    config = {**TRAIN_CONFIG, "num_workers": 6, "data": {
        "train": kvq_split(root, "train", "train", TRAIN_VIEW,
                           SyntheticVideos()),
        "val": kvq_split(root, "val", "test", VAL_VIEW, SyntheticVideos())}}
    work = os.path.join(root, "work")
    state = os.path.join(work, "KSVQE_last_state.pt")

    # each train epoch inside the CLI is timed from its first batch request
    # to its losses read back (the host pipeline included)
    epoch_s = []
    train_epoch = Trainer.train_epoch

    def timed_epoch(self, batches):
        t0 = time.perf_counter()
        out = train_epoch(self, batches)
        epoch_s.append(time.perf_counter() - t0)
        return out

    reset_counts()
    runs = []
    Trainer.train_epoch = timed_epoch
    try:
        for resume in (None, state):
            t0 = time.perf_counter()
            tr = cli_train.run(config, work, "val", epochs=1, seed=0,
                               resume_from=resume, device="cuda")
            wall = time.perf_counter() - t0
            runs.append((wall, epoch_s[-1], dict(tr.last_losses)))
            if not all(map(math.isfinite, tr.last_losses.values())):
                fail(f"cli.train: losses not finite: {tr.last_losses}")
    finally:
        Trainer.train_epoch = train_epoch
    counts = kernel_counts()
    steps, evals = tr.step, 2 * 2 * CLI_VAL_VIDEOS  # raw + EMA, 2 epochs
    spe = CLI_TRAIN_VIDEOS // TRAIN_B
    want_lr = 3e-5 * schedule_factor(steps, int(2.5 * spe), 50 * spe)
    lr = tr.optimizer.param_groups[0]["lr"]
    files = sorted(os.listdir(work))
    print(f"cli.train.run: step {steps} after one epoch and one resumed "
          f"epoch; lr {lr:.6g} (schedule at update {steps}: {want_lr:.6g}); "
          f"files {files}; launches {counts}; per run: wall (build, 2 steps, "
          f"evaluation of {CLI_VAL_VIDEOS} videos twice, state written) "
          f"{[round(r[0], 3) for r in runs]} s, its train epoch (first batch "
          f"asked for to losses read) {[round(r[1], 3) for r in runs]} s = "
          f"{[round(spe / r[1], 3) for r in runs]} steps/s including the "
          f"host pipeline; last losses {[r[2] for r in runs]}; {card}",
          flush=True)
    if steps != 2 * spe or tr.schedule.last_epoch != steps:
        fail(f"cli.train: step {steps}, schedule at "
             f"{tr.schedule.last_epoch}, expected {2 * spe}")
    if not math.isclose(lr, want_lr, rel_tol=1e-9, abs_tol=1e-15):
        fail("cli.train: the schedule did not continue")
    if files != ["KSVQE_head_val_n_finetuned.pth",
                 "KSVQE_head_val_s_finetuned.pth", "KSVQE_last_state.pt"]:
        fail(f"cli.train: wrote {files}")
    if counts != dict(NO_LAUNCHES, train_swin_block=10 * steps,
                      train_swin_block_bwd=10 * steps,
                      window_attention_train=2 * steps,
                      window_attention_train_bwd=2 * steps,
                      fused_swin_block=12 * evals,
                      flash_attention_nobias_cl=9 * evals):
        fail(f"cli.train: expected K4 10 + 10 and K5 2 + 2 a step and 12 "
             f"K1 + 9 K2 a val forward, got {counts}")
    norms = torch.stack(torch._foreach_norm(tr.params))
    if not bool(torch.isfinite(norms).all()):
        fail("cli.train: trained parameters are not finite")
    del tr
    torch.cuda.empty_cache()
    shutil.rmtree(root)
    return {"steps": steps, "lr": lr, "files": files, "launches": counts,
            "runs": [{"wall_s": w, "train_epoch_s": e,
                      "steps_per_s": spe / e, "last_losses": l}
                     for w, e, l in runs]}


# --------------------------------------------------------------------------
# SimpleVQA (config/kwai_simpleVQA.yml): eval, training, the path from mp4s

SVQA_CONFIG = os.path.join(ROOT, "config", "kwai_simpleVQA.yml")
SVQA_T, SVQA_CROP = 8, 448      # the config's clip_len and crop
# the timed runs last seconds: SVQA_EVAL_BATCHES scored batches and
# SVQA_TRAIN_STEPS train steps (after one warm-up step), cycling through
# SVQA_DISTINCT prepared batches (each is prepared and copied anew)
SVQA_EVAL_BATCHES = 256
SVQA_TRAIN_STEPS = 64
SVQA_DISTINCT = 8
# f32 on the card (TF32 off) against f32 on the CPU, same weights and batch:
# the eval score within SVQA_TOL x max(1, |score|); one train step's loss
# within SVQA_TRAIN_TOL x |loss|, and each running mean and variance within
# SVQA_TRAIN_TOL x its tensor's largest magnitude.  The bound is per tensor,
# not per element: a channel's batch mean can sit near 0, where the f32
# roundoff of summing the channel's activations in another order is not
# relative to it (the per-element |d| / (|cpu| + 1e-3) is printed too).
# ResNet-50 sums in other orders on the two (cuDNN, oneDNN).  A control,
# the card's step with TF32 on, must fall outside these bounds, or they
# could not see a fault of TF32's size.  SlowFast-R50's features of
# SF_CHECK_CLIPS clips: within SF_TOL x max(1, max |feature|) of each
# pathway, a bound that the CLI's own files (TF32) do not meet.
SVQA_TOL = 1e-3
SVQA_TRAIN_TOL = 1e-4
SF_TOL = 1e-5
SF_CHECK_CLIPS = 4
SVQA_FILES = (32, 16)           # train, val mp4 files of the user path
SVQA_FPS = 30


def _svqa_family(name: str) -> str:
    """Kernel families of a ResNet forward and backward."""
    low = name.lower()
    if any(k in low for k in ("conv", "cudnn", "implicit", "fprop", "dgrad",
                              "wgrad", "xmma")):
        return "conv (cuDNN)"
    if any(k in low for k in ("gemm", "cutlass", "sm90", "nvjet")):
        return "matmul (cuBLAS)"
    if "batch_norm" in low or "batchnorm" in low or "welford" in low:
        return "batch norm"
    if "reduce" in low:
        return "reduction"
    if "elementwise" in low or "vectorized" in low or "unrolled" in low:
        return "elementwise"
    return "other"


def svqa_config() -> dict:
    from kvq_tpu_torch.core.config import load_config

    return load_config(SVQA_CONFIG)


def svqa_views(rng, n: int, t: int = SVQA_T, size: int = SVQA_CROP):
    """(n, t, size, size, 3) views as SimpleVQADataset ships them: 0-255
    pixels under the reference's imagenet_unit_on_255 normalisation
    (values in about [-2, 1113])."""
    from kvq_tpu_torch.data import views as V

    return np.stack([V.normalize(rng.integers(0, 256, (t, size, size, 3),
                                              dtype=np.uint8),
                                 "imagenet_unit_on_255") for _ in range(n)])


def make_svqa_batch(rng, i: int, b: int = 1, t: int = SVQA_T,
                    size: int = SVQA_CROP) -> dict:
    """A SimpleVQA batch in the Loader's format: the views, the SlowFast
    features (one 2304-vector a frame), labels."""
    return {"simpleVQA": svqa_views(rng, b, t, size),
            "feat": rng.standard_normal((b, t, 2304), dtype=np.float32),
            "label": rng.standard_normal(b).astype(np.float32),
            "video_name": [f"svqa_{i:03d}_{j}.mp4" for j in range(b)],
            "num_clips": [{"simpleVQA": 1}] * b}


def layer_flops(model, run) -> float:
    """2 x the multiply-adds of every Conv2d and Linear over one call of
    ``run``, from their output shapes."""
    import torch

    total = [0.0]

    def hook(m, _, out):
        k = m.weight[0].numel() if isinstance(m, torch.nn.Conv2d) \
            else m.in_features
        total[0] += 2.0 * out.numel() * k

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


class tf32:
    """f32 convolutions and products in TF32 or not (cuDNN takes TF32 by
    default, cuBLAS does not)."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        import torch

        self.saved = (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = self.on
        torch.backends.cuda.matmul.allow_tf32 = self.on

    def __exit__(self, *exc):
        import torch

        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.saved


def svqa_eval_path(card: str) -> dict:
    """SimpleVQA scoring at config/kwai_simpleVQA.yml's model block (bf16,
    ResNet-50, head 9472 -> 128 -> 1): B=1, T=8 at 448x448 plus the SlowFast
    features, prepared batches through ``Evaluator.inference_test``."""
    import torch

    from kvq_tpu_torch.data.pipeline import (
        host_tensors, pad_batch_rows, reshape_for_clips)
    from kvq_tpu_torch.models.vqa_network import build_model
    from kvq_tpu_torch.train.evaluator import Evaluator

    t_phase = time.time()
    cfg = svqa_config()
    model_cfg = {"name": cfg["name"], "model": cfg["model"]}
    args = cfg["model"]["args"]["simpleVQA"]
    t0 = time.time()
    model = build_model(model_cfg, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    layers = tuple(len(getattr(model.simpleVQA_backbone, f"layer{i}"))
                   for i in range(1, 5))
    q = model.simpleVQA_head.quality
    print(f"SimpleVQA eval model: {SVQA_CONFIG[len(ROOT) + 1:]}'s model "
          f"block ({cfg['model']['compute_dtype']}, ResNet-50 layers "
          f"{layers}, head {q[0].in_features} -> {q[0].out_features} -> 1; "
          f"backbone {args.get('backbone')}), {n_params} parameters, seeded "
          f"weights; built in {time.time() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(5)
    distinct = [make_svqa_batch(rng, i) for i in range(SVQA_DISTINCT)]
    batches = [distinct[i % SVQA_DISTINCT] for i in range(SVQA_EVAL_BATCHES)]
    ev = Evaluator(model_cfg, model=model, device="cuda")
    root = tempfile.mkdtemp(prefix="kvq_svqa_eval_")
    out_path = os.path.join(root, "output.txt")
    ev.inference_test(batches[:1], out_path)  # warm-up: cuDNN's choices
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    results = ev.inference_test(batches, out_path)
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    scores = [s for _, s in results]
    with open(out_path) as f:
        lines = f.read().splitlines()
    print(f"SimpleVQA eval: {len(results)} videos scored in {wall:.3f} s = "
          f"{len(results) / wall:.3f} videos/s (B=1, T={SVQA_T}, "
          f"{SVQA_CROP}x{SVQA_CROP}, bf16; {card}); kernel launches "
          f"{counts} (no kernel of the port on this path)", flush=True)
    if len(scores) != SVQA_EVAL_BATCHES or not all(map(math.isfinite,
                                                       scores)):
        fail(f"SimpleVQA scores not finite or missing: {scores}")
    if lines != [f"{n},{s}" for n, s in results]:
        fail("SimpleVQA output.txt does not hold the scored videos")
    if counts != NO_LAUNCHES:
        fail(f"SimpleVQA eval launched a kernel of the port: {counts}")

    hb = host_tensors(reshape_for_clips(pad_batch_rows(batches[0], 1),
                                        ["simpleVQA"]), torch.bfloat16,
                      pin=True)
    dev = {k: v.cuda() for k, v in hb.items()}
    prof = forward_timings(model, dev, wall / len(results) * 1e3, card,
                           _svqa_family)

    def forward():
        with torch.no_grad():
            model(dev, reduce_scores=True)

    flops = layer_flops(model, forward)
    nbytes = (sum(t.numel() * t.element_size() for t in dev.values())
              + sum(p.numel() * p.element_size() for p in model.parameters()))
    bound, bound_by = bound_ms(nbytes, flops)
    print(f"SimpleVQA forward: {flops / 1e9:.1f} GFLOP (convolutions and "
          f"products, from their shapes) = {flops / 1e9 / SVQA_T:.2f} a frame; "
          f"bound {bound:.4f} ms ({bound_by}: bf16 at 989 TFLOP/s, 3.35 TB/s); "
          f"the forward on a device-resident batch {prof['forward_ms']:.3f} "
          f"ms = {prof['forward_ms'] / bound:.2f}x the bound; {card}",
          flush=True)

    # the same weights and batch in f32: the card with TF32 off against the
    # CPU; then the bf16 score's gap to the f32 one
    cfg32 = json.loads(json.dumps(model_cfg))
    cfg32["model"]["compute_dtype"] = "float32"
    sd = model.state_dict()
    host = host_tensors(reshape_for_clips(pad_batch_rows(batches[0], 1),
                                          ["simpleVQA"]), None, pin=False)
    t0 = time.time()
    with torch.no_grad():
        cpu_score = float(build_model(cfg32, device="cpu", state_dict=sd)(
            host, reduce_scores=True).reshape(()))
    cpu_s = time.time() - t0
    gpu32 = build_model(cfg32, device="cuda", state_dict=sd)
    with tf32(False), torch.no_grad():
        gpu_score = float(gpu32({k: v.cuda() for k, v in host.items()},
                                reduce_scores=True).reshape(()))
    d = abs(gpu_score - cpu_score)
    tol = SVQA_TOL * max(1.0, abs(cpu_score))
    bf16_gap = abs(scores[0] - gpu_score)
    print(f"SimpleVQA f32 score on the card (TF32 off) {gpu_score:.7f} vs "
          f"the CPU {cpu_score:.7f} ({cpu_s:.1f} s): |d| {d:.3g} (tol "
          f"{tol:.3g}); the bf16 score {scores[0]:.7f}, |d| to the f32 one "
          f"{bf16_gap:.4g} (reported: the view's values reach ~1113, and a "
          f"bf16 input keeps 8 bits)", flush=True)
    if not d <= tol:
        fail("SimpleVQA's f32 score on the card disagrees with the CPU's")
    del gpu32, model, ev
    torch.cuda.empty_cache()
    shutil.rmtree(root)
    phase_s = time.time() - t_phase
    print(f"SimpleVQA eval phase: {phase_s:.1f} s", flush=True)
    prof.update(videos_per_s=len(results) / wall, launches=counts,
                flops=flops, bound_ms=bound, bound_by=bound_by,
                score_f32_card=gpu_score, score_f32_cpu=cpu_score,
                score_abs_diff=d, bf16_abs_gap=bf16_gap, phase_s=phase_s)
    prof.pop("top_host_ops", None)
    return prof


def _bn_stats(model) -> dict:
    from kvq_tpu_torch.nn.resnet import BatchNorm

    return {n: (m.running_mean.detach().clone(), m.running_var.detach().clone(),
                int(m.num_batches_tracked))
            for n, m in model.named_modules() if isinstance(m, BatchNorm)}


def _stats_gap(want: dict, got: dict) -> dict:
    """The worst gap of ``got``'s running statistics to ``want``'s (both
    from :func:`_bn_stats`): max|d| / max|want| of a tensor, and |d| /
    (|want| + 1e-3) of an element, with where each is."""
    out = {"per_tensor": 0.0, "per_tensor_at": "", "per_element": 0.0,
           "per_element_at": ""}
    for n, (m, v, _) in want.items():
        for kind, g, w in (("mean", got[n][0].cpu(), m),
                           ("var", got[n][1].cpu(), v)):
            d = (g - w).abs()
            for key, r in (("per_tensor", (d.max() / w.abs().max()).item()),
                           ("per_element",
                            (d / (w.abs() + 1e-3)).max().item())):
                if r > out[key]:
                    out[key], out[f"{key}_at"] = r, f"{n} running_{kind}"
    return out


def svqa_train_path(card: str) -> dict:
    """SimpleVQA training at config/kwai_simpleVQA.yml's settings (B=4,
    T=8 at 448x448, AdamW, warmup + cosine, EMA, BatchNorm in train mode)
    through ``Trainer.train_epoch``; then one f32 step at the same shape on
    the card (TF32 off, and TF32 on as the control) against the same step
    on the CPU."""
    import torch

    from kvq_tpu_torch.train.trainer import Trainer

    t_phase = time.time()
    cfg = {k: v for k, v in svqa_config().items() if k != "data"}
    b = int(cfg["batch_size"])
    rng = np.random.default_rng(6)
    distinct = [make_svqa_batch(rng, i, b) for i in range(SVQA_DISTINCT)]
    batches = [distinct[i % SVQA_DISTINCT]
               for i in range(SVQA_TRAIN_STEPS + 1)]
    tr = Trainer(cfg, device="cuda", seed=0, steps_per_epoch=100)
    params0 = [p.detach().clone() for p in tr.params]
    ema0 = [e.clone() for e in tr.ema]
    stats0 = _bn_stats(tr.model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr.train_step(batches[0])  # warm-up: cuDNN's choices
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    last = tr.train_epoch(batches[1:])
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = SVQA_TRAIN_STEPS
    print(f"SimpleVQA train: {steps} steps in {wall:.3f} s = "
          f"{steps / wall:.3f} steps/s = {steps * b / wall:.3f} videos/s "
          f"(B={b}, T={SVQA_T}, {SVQA_CROP}x{SVQA_CROP}, bf16 compute, f32 "
          f"masters); last losses {last}; kernel launches {counts}; peak "
          f"memory {peak / 2 ** 30:.3f} GiB; {card}", flush=True)
    if counts != NO_LAUNCHES:
        fail(f"SimpleVQA train launched a kernel of the port: {counts}")
    check_trained(tr, ema0, last)
    moved = max((p - p0).abs().max().item()
                for p, p0 in zip(tr.params, params0))
    if not moved > 0:
        fail("SimpleVQA: the parameters did not move")
    stats = _bn_stats(tr.model)
    still = [n for n, (m, v, k) in stats.items()
             if torch.equal(m, stats0[n][0]) or torch.equal(v, stats0[n][1])
             or m.dtype != torch.float32 or v.dtype != torch.float32
             or k != stats0[n][2] + steps + 1]
    print(f"SimpleVQA train: parameters moved by up to {moved:.3g}; "
          f"{len(stats)} BatchNorms, running statistics float32 and updated "
          f"once a step: {len(stats) - len(still)} of {len(stats)}",
          flush=True)
    if still:
        fail(f"SimpleVQA: running statistics not updated once a step, or "
             f"not f32: {still[:4]}")
    del params0, ema0
    prof = step_timings(tr, batches[1], wall / steps * 1e3, card,
                        _svqa_family)
    del tr
    torch.cuda.empty_cache()

    # one f32 step at the cell's shape on the card (TF32 off) against the
    # same step on the CPU; the control is the card's step with TF32 on
    cfg32 = json.loads(json.dumps(cfg))
    cfg32["model"]["compute_dtype"] = "float32"
    batch = batches[1]
    tc = Trainer(cfg32, device="cpu", seed=0, steps_per_epoch=100)
    init = {k: v.clone() for k, v in tc.model.state_dict().items()}
    t0 = time.time()
    aux_c = tc.train_step(batch)
    cpu_s = time.time() - t0
    sc = _bn_stats(tc.model)
    del tc
    ltol = SVQA_TRAIN_TOL * abs(aux_c["total_loss"])
    check = {"loss_cpu": aux_c["total_loss"], "cpu_s": cpu_s}
    for label, on in (("TF32 off", False), ("control, TF32 on", True)):
        tg = Trainer(cfg32, device="cuda", seed=0, steps_per_epoch=100)
        tg.model.load_state_dict(init)
        with tf32(on):
            aux_g = tg.train_step(batch)
        gap = _stats_gap(sc, _bn_stats(tg.model))
        dl = abs(aux_g["total_loss"] - aux_c["total_loss"])
        within = dl <= ltol and gap["per_tensor"] <= SVQA_TRAIN_TOL
        print(f"SimpleVQA f32 train step (B={b}, T={SVQA_T}, "
              f"{SVQA_CROP}x{SVQA_CROP}) on the card ({label}) vs the CPU "
              f"({cpu_s:.1f} s): loss {aux_g['total_loss']:.7f} vs "
              f"{aux_c['total_loss']:.7f}, |d| {dl:.3g} (tol {ltol:.3g}); "
              f"running statistics, worst max|d| / max|cpu| of a tensor "
              f"{gap['per_tensor']:.3g} at {gap['per_tensor_at']} (tol "
              f"{SVQA_TRAIN_TOL}), worst |d| / (|cpu| + 1e-3) of an element "
              f"{gap['per_element']:.3g} at {gap['per_element_at']} "
              f"(printed, not bounded); within the bounds: {within}",
              flush=True)
        check[label] = dict(gap, loss_card=aux_g["total_loss"],
                            loss_abs_diff=dl, within=within)
        del tg
        torch.cuda.empty_cache()
        if not on and not within:
            fail("SimpleVQA: the card's f32 train step disagrees with the "
                 "CPU's")
        if on and within:
            fail("SimpleVQA: the TF32 control is within the bounds of the "
                 "card-vs-CPU train step, which cannot see it")
    phase_s = time.time() - t_phase
    print(f"SimpleVQA train phase: {phase_s:.1f} s", flush=True)
    prof.pop("top_host_ops", None)
    prof.update(steps_per_s=steps / wall, videos_per_s=steps * b / wall,
                launches=counts, peak_memory_bytes=peak, last=last,
                cpu_check=check, phase_s=phase_s)
    return prof


def write_mp4(path: str, seed: int) -> None:
    """CLI_FRAMES frames of CLI_W x CLI_H (portrait) at SVQA_FPS, mp4v: a
    smooth seeded pattern scrolling and a square crossing it."""
    import cv2

    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (CLI_H // 40, CLI_W // 40, 3),
                         dtype=np.uint8)
    base = cv2.resize(small, (CLI_W, CLI_H), interpolation=cv2.INTER_CUBIC)
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), SVQA_FPS,
                         (CLI_W, CLI_H))
    try:
        for t in range(CLI_FRAMES):
            frame = np.roll(base, 6 * t, axis=0)
            x, y = (5 * t) % (CLI_W - 120), (3 * t) % (CLI_H - 120)
            frame[y:y + 120, x:x + 120] = (40 * seed) % 256
            wr.write(frame)
    finally:
        wr.release()


def svqa_host_ms(dataset, n: int) -> dict:
    """The host's ms per video of a SimpleVQADataset, by stage, one thread:
    cv2's decode of the sampled frames, the resize and crop, the
    normalisation, the features read and the collate."""
    from kvq_tpu_torch.data import views as V
    from kvq_tpu_torch.data.datasets import _filter_view_opts
    from kvq_tpu_torch.data.decode import decode_views, open_video
    from kvq_tpu_torch.data.pipeline import collate

    ms = dict.fromkeys(("cv2 decode", "resize + crop", "normalise",
                        "features", "collate"), 0.0)

    def timed(stage, fn, *a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        ms[stage] += (time.perf_counter() - t0) * 1e3 / n
        return out

    sopt = _filter_view_opts(dataset.sample_types["simpleVQA"])
    for i in range(n):
        info = dataset.video_infos[i]
        rng = dataset._rng(i)
        videos, _ = timed("cv2 decode", lambda: decode_views(
            open_video(info["filename"], pad_short=130),
            dataset._samplers(rng), False))
        view = timed("resize + crop", V.get_single_view, videos["simpleVQA"],
                     "simpleVQA", rng=rng, phase=dataset.phase, **sopt)
        view = timed("normalise", V.normalize, view, "imagenet_unit_on_255")
        feat = timed("features", dataset._load_features, info["video_name"])
        timed("collate", collate, [{"simpleVQA": view, "feat": feat,
                                    "label": 1.0, "video_name": "v"}])
    return ms


def slowfast_check(video: str, feat_dir: str, card: str) -> dict:
    """SlowFast-R50's features of the first SF_CHECK_CLIPS clips of
    ``video``, with the weights ``cli.slowfast_features`` seeded on the
    card: the card in f32 with TF32 off against the CPU (bounded), and the
    files the CLI wrote (cuDNN's default TF32) against the CPU (printed)."""
    import torch

    from kvq_tpu_torch.cli import slowfast_features as cli_sf

    resized, fps = cli_sf.read_resized(video)
    clips = cli_sf.clips_of(resized, fps)[:SF_CHECK_CLIPS]
    gpu = cli_sf.load_model(None, torch.device("cuda"))
    cpu = cli_sf.load_model(None, torch.device("cpu"))
    cpu.load_state_dict(gpu.state_dict())
    t0 = time.time()
    want = cli_sf.extract_features(cpu, clips, torch.device("cpu"))
    cpu_s = time.time() - t0
    with tf32(False):
        got = cli_sf.extract_features(gpu, clips, torch.device("cuda"))
    files = [tuple(np.load(os.path.join(feat_dir,
                                        f"feature_{k}_{kind}_feature.npy"))
                   for kind in ("slow", "fast")) for k in range(len(clips))]
    out = {"cpu_s": cpu_s}
    for label, feats in (("card", got), ("files", files)):
        for pi, kind in enumerate(("slow", "fast")):
            w = np.stack([f[pi] for f in want])
            d = float(np.abs(np.stack([f[pi] for f in feats]) - w).max())
            out[f"{label}_{kind}"] = d
            out[f"{kind}_tol"] = SF_TOL * max(1.0, float(np.abs(w).max()))
    print(f"SlowFast-R50 features of {len(clips)} clips of "
          f"{os.path.basename(video)}, f32 on the card (TF32 off) vs the CPU "
          f"({cpu_s:.1f} s): max|d| slow {out['card_slow']:.3g} (tol "
          f"{out['slow_tol']:.3g}), fast {out['card_fast']:.3g} (tol "
          f"{out['fast_tol']:.3g}); the CLI's files (TF32) vs the CPU: slow "
          f"{out['files_slow']:.3g}, fast {out['files_fast']:.3g} (printed); "
          f"{card}", flush=True)
    if not (out["card_slow"] <= out["slow_tol"]
            and out["card_fast"] <= out["fast_tol"]):
        fail("SlowFast-R50's features on the card disagree with the CPU's")
    del gpu
    torch.cuda.empty_cache()
    return out


def svqa_files_path(card: str) -> dict:
    """The SimpleVQA user's path from mp4 files: SlowFast features through
    ``cli.slowfast_features.main``, one epoch of ``cli.train.run`` and
    ``cli.test.run`` on config/kwai_simpleVQA.yml pointed at the files."""
    import torch

    from kvq_tpu_torch.cli import slowfast_features as cli_sf
    from kvq_tpu_torch.cli import test as cli_test
    from kvq_tpu_torch.cli import train as cli_train
    from kvq_tpu_torch.data import datasets as PD
    from kvq_tpu_torch.data.pipeline import build_loaders
    from kvq_tpu_torch.train.evaluator import Evaluator
    from kvq_tpu_torch.train.trainer import Trainer

    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="kvq_svqa_files_")
    vids, feat = os.path.join(root, "videos"), os.path.join(root, "feat")
    os.makedirs(vids)
    rng = np.random.default_rng(8)
    splits = {s: [(f"{s}_{i}.mp4", float(rng.uniform(1, 5))) for i in range(n)]
              for s, n in zip(("train", "val"), SVQA_FILES)}
    names = [n for rows in splits.values() for n, _ in rows]
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(lambda a: write_mp4(os.path.join(vids, a[1]), a[0]),
                      enumerate(names)))
    write_s = time.time() - t0
    for s, rows in splits.items():
        with open(os.path.join(root, f"{s}.csv"), "w") as f:
            f.write("filename,score\n")
            f.writelines(f"{n},{v}\n" for n, v in rows)
    with open(os.path.join(root, "all.csv"), "w") as f:
        f.write("filename\n")
        f.writelines(f"{n}\n" for n in names)
    print(f"SimpleVQA files: {len(names)} mp4s (mp4v) of {CLI_FRAMES} frames,"
          f" {CLI_W}x{CLI_H} (W x H, portrait) at {SVQA_FPS} fps, written by "
          f"cv2 in {write_s:.1f} s", flush=True)

    t0 = time.perf_counter()
    sf = cli_sf.main(["--videos_csv", os.path.join(root, "all.csv"),
                      "--video_root", vids, "--out", feat])
    sf_s = time.perf_counter() - t0
    for n in names:
        for k in range(10):
            for kind, dim in (("slow", 2048), ("fast", 256)):
                a = np.load(os.path.join(feat, n,
                                         f"feature_{k}_{kind}_feature.npy"))
                if a.shape != (dim,) or not np.isfinite(a).all():
                    fail(f"slowfast_features: {n} clip {k} {kind}: "
                         f"{a.shape}, finite {np.isfinite(a).all()}")
    print(f"cli.slowfast_features: {sf['videos']} videos, {sf['clips']} clips "
          f"in {sf_s:.3f} s (model build included) = {sf['clips'] / sf_s:.3f} "
          f"clips/s; cv2 decode and resize {sf['decode_s'] / sf['videos'] * 1e3:.1f}"
          f" ms a video, clip assembly and normalisation "
          f"{sf['clips_s'] / sf['videos'] * 1e3:.1f} ms a video; SlowFast-R50 "
          f"(f32, cuDNN's default TF32; clips batched by video, copies "
          f"included) {sf['model_s'] / sf['clips'] * 1e3:.2f} ms a clip; "
          f"{card}", flush=True)
    if sf["videos"] != len(names) or sf["clips"] != 10 * len(names):
        fail(f"slowfast_features: {sf}")
    sf_check = slowfast_check(os.path.join(vids, names[0]),
                              os.path.join(feat, names[0]), card)

    cfg = svqa_config()
    cfg["load_path"] = cfg["test_load_path"] = None
    for s in ("train", "val"):
        cfg["data"][s]["args"].update(
            anno_file=os.path.join(root, f"{s}.csv"), data_prefix=vids,
            data_prefix_3D=feat)
    work = os.path.join(root, "work")
    epoch_s, step_t = [], []
    train_epoch, step = Trainer.train_epoch, Trainer._step

    def timed_epoch(self, batches):
        t0 = time.perf_counter()
        out = train_epoch(self, batches)
        epoch_s.append(time.perf_counter() - t0)
        return out

    def timed_step(self, dev):
        step_t.append(time.perf_counter())
        return step(self, dev)

    Trainer.train_epoch, Trainer._step = timed_epoch, timed_step
    try:
        t0 = time.perf_counter()
        tr = cli_train.run(cfg, work, "val", epochs=1, seed=0, device="cuda")
        train_wall = time.perf_counter() - t0
    finally:
        Trainer.train_epoch, Trainer._step = train_epoch, step
    spe = SVQA_FILES[0] // int(cfg["batch_size"])
    steady = (len(step_t) - 1) / (step_t[-1] - step_t[0])
    files = sorted(os.listdir(work))
    print(f"cli.train.run (SimpleVQA): step {tr.step}, files {files}; wall "
          f"{train_wall:.3f} s (build, {spe} steps, {SVQA_FILES[1]} val "
          f"videos scored twice, state written); its train epoch (first "
          f"batch asked for to losses read) {epoch_s[0]:.3f} s = "
          f"{spe / epoch_s[0]:.3f} steps/s; after the first batch "
          f"{len(step_t) - 1} steps from the first step's start to the "
          f"last's in {step_t[-1] - step_t[0]:.3f} s = {steady:.3f} steps/s "
          f"= {steady * int(cfg['batch_size']):.3f} videos/s; last losses "
          f"{tr.last_losses}; {card}", flush=True)
    if files != ["SimpleVQA_head_val_n_finetuned.pth",
                 "SimpleVQA_head_val_s_finetuned.pth",
                 "SimpleVQA_last_state.pt"] or tr.step != spe:
        fail(f"cli.train (SimpleVQA): step {tr.step}, wrote {files}")
    if not all(map(math.isfinite, tr.last_losses.values())):
        fail(f"cli.train (SimpleVQA): losses not finite: {tr.last_losses}")
    del tr
    torch.cuda.empty_cache()

    test_cfg = dict(cfg, test_load_path=os.path.join(
        work, "SimpleVQA_head_val_s_finetuned.pth"))
    _, loader = build_loaders(test_cfg)
    t0 = time.perf_counter()
    batches = list(loader.epoch(0))
    loader_s = time.perf_counter() - t0
    host_ms = svqa_host_ms(loader.dataset, SVQA_FILES[1])
    want = dict(Evaluator(test_cfg, device="cuda").inference_test(
        batches, os.path.join(root, "ref.txt")))
    out = os.path.join(root, "output.txt")
    first = []
    open_video = PD.open_video
    PD.open_video = lambda *a, **k: (first.append(time.perf_counter())
                                     or open_video(*a, **k))
    try:
        results = cli_test.run(test_cfg, out)
        end = time.perf_counter()
    finally:
        PD.open_video = open_video
    e2e_s = end - first[0]
    prof = profile_device(lambda: cli_test.run(test_cfg, out + ".profiled"),
                          _svqa_family)
    idle = 1.0 - prof["device_ms"] / (e2e_s * 1e3)
    n_val = SVQA_FILES[1]
    scores = [s for _, s in results]
    diffs = [abs(s - want[n]) for n, s in results]
    print(f"cli.test.run (SimpleVQA): {n_val} files scored in {e2e_s:.3f} s "
          f"from the first file opened to output.txt written = "
          f"{n_val / e2e_s:.3f} videos/s; the Loader alone "
          f"({loader.num_workers} threads) {n_val / loader_s:.3f} videos/s; "
          f"host ms per video by stage, one thread "
          f"{json.dumps({k: round(v, 2) for k, v in host_ms.items()})}; device "
          f"busy over a profiled run {prof['device_ms']:.2f} ms, idle share "
          f"{idle:.3f} of the unprofiled run; scores against the Evaluator "
          f"on the Loader's batches max|d| {max(diffs):.3g}; {card}",
          flush=True)
    if [n for n, _ in results] != [n for n, _ in splits["val"]] or not all(
            map(math.isfinite, scores)):
        fail(f"cli.test (SimpleVQA): {results}")
    if not max(d / (SCORE_TOL * max(1.0, abs(want[n])))
               for d, (n, _) in zip(diffs, results)) <= 1.0:
        fail("cli.test (SimpleVQA): scores disagree with the Evaluator's")
    phase_s = time.time() - t_phase
    print(f"SimpleVQA files phase: {phase_s:.1f} s", flush=True)
    return {"write_s": write_s, "slowfast": sf, "slowfast_s": sf_s,
            "clips_per_s": sf["clips"] / sf_s,
            "decode_ms_per_video": sf["decode_s"] / sf["videos"] * 1e3,
            "slowfast_ms_per_clip": sf["model_s"] / sf["clips"] * 1e3,
            "slowfast_check": sf_check,
            "train_wall_s": train_wall, "train_epoch_s": epoch_s[0],
            "train_epoch_steps_per_s": spe / epoch_s[0],
            "train_steady_steps_per_s": steady,
            "test_videos_per_s": n_val / e2e_s,
            "loader_videos_per_s": n_val / loader_s, "host_ms": host_ms,
            "device_busy_ms": prof["device_ms"], "idle_share": idle,
            "families_ms": prof["families_ms"],
            "max_abs_score_diff": max(diffs), "phase_s": phase_s,
            "files": {"root": root, "videos": vids, "splits": splits}}


# --------------------------------------------------------------------------
# Data-parallel (kvq_tpu_torch/parallel/): the DDP step over NCCL at one
# rank; two ranks sharing the one card over gloo (NCCL refuses two ranks on
# one GPU): SimpleVQA's synced-BatchNorm step and the gathered KSVQE
# cli.test; the user's torchrun launch of cli.train

DDP_TIMEOUT = 300      # seconds a spawned rank or torchrun may take
SVQA_DDP_STEPS = 3     # timed two-rank steps after the compared one
DDP_SEED = 12          # the two-rank SimpleVQA batches: every rank makes them
GRAD_FLOOR = 1e-2      # of the largest gradient: the least scale of one
SVQA_F64_B, SVQA_F64_T = 4, 2  # the float64 check's videos a rank, frames
# its reduced gradients against a float64 emulation: the model's pools run
# in f32 (nn/layers.py:avg_std_pool) even in float64, so the two carry f32
# roundoff of the pooled features and their cotangents
SVQA_F64_TOL = 1e-5
DDP_RANK_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def nccl_ddp_path(card: str) -> dict:
    """(a) KSVQE training at full width (B=4, T=32, random parts on)
    through the Trainer's DDP route in a one-rank NCCL group: one step
    against the one-process Trainer's on the same batch and seed (loss and
    every gradient), the gradient all-reduce timed alone, then timed steps
    that must launch K4 10 + 10 and K5 2 + 2 a step."""
    import torch
    import torch.distributed as dist

    from kvq_tpu_torch.parallel import init_distributed
    from kvq_tpu_torch.parallel.steps import reduce_gradients
    from kvq_tpu_torch.train.trainer import Trainer

    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()))
    try:
        dev = init_distributed("cuda")
        backend = dist.get_backend()
        rng = np.random.default_rng(11)
        batches = [make_train_batch(rng, i) for i in range(TRAIN_STEPS + 1)]
        td = Trainer(dict(TRAIN_CONFIG, ddp=True), device=dev, seed=0,
                     steps_per_epoch=100)
        tp = Trainer(TRAIN_CONFIG, device=dev, seed=0, steps_per_epoch=100)
        if not td.ddp or tp.ddp or backend != "nccl":
            fail(f"DDP route: ddp {td.ddp}, plain {tp.ddp}, {backend}")
        aux_d, aux_p = td.train_step(batches[0]), tp.train_step(batches[0])
        d_loss = max(abs(aux_d[k] - aux_p[k]) for k in aux_p)
        d_grad = max((a.grad - b.grad).abs().max().item()
                     for a, b in zip(td.params, tp.params)
                     if b.grad is not None)
        print(f"DDP step ({backend}, 1 rank) vs the one-process step, same "
              f"batch and seed: max|d| loss {d_loss:.3g}, gradients "
              f"{d_grad:.3g} (expected 0; K4's and K5's backward sum with "
              f"atomics)", flush=True)
        agree = step_agreement("DDP step (NCCL, 1 rank) vs one-process step",
                               td, tp, aux_d, aux_p, "KSVQE_backbone.layers.")
        del tp
        torch.cuda.empty_cache()
        n_grad = sum(p.numel() for p in td.params if p.requires_grad)
        ar_ms = cuda_ms(lambda: reduce_gradients(td.params), 5)
        ar_prof = profile_device(lambda: reduce_gradients(td.params))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        last = td.train_epoch(batches[1:])
        wall = time.perf_counter() - t0
        counts = kernel_counts()
        peak = torch.cuda.max_memory_allocated()
        steps = TRAIN_STEPS
        print(f"DDP train path (NCCL, 1 rank): {steps} steps in {wall:.3f} s "
              f"= {steps / wall:.3f} steps/s (B={TRAIN_B}, T={TRAIN_T}); the "
              f"gradient all-reduce of {n_grad} f32 gradients "
              f"({n_grad * 4 / 1e6:.1f} MB, buckets of 25 MiB): {ar_ms:.3f} "
              f"ms (CUDA events), device {ar_prof['device_ms']:.3f} ms by "
              f"family {json.dumps(ar_prof['families_ms'])}, "
              f"{ar_prof['launch_calls']} launch calls; launches {counts}; "
              f"peak memory {peak / 2 ** 30:.3f} GiB (the flat buckets "
              f"included); last losses {last}; {card}", flush=True)
        want = dict(NO_LAUNCHES, train_swin_block=10 * steps,
                    train_swin_block_bwd=10 * steps,
                    window_attention_train=2 * steps,
                    window_attention_train_bwd=2 * steps)
        if counts != want:
            fail(f"DDP route: expected 10 + 10 K4 and 2 + 2 K5 launches a "
                 f"step, got {counts}")
        if not all(map(math.isfinite, last.values())):
            fail(f"DDP route: losses not finite: {last}")
        prof = step_timings(td, batches[1], wall / steps * 1e3, card)
        del td
        torch.cuda.empty_cache()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in DDP_RANK_ENV:
            os.environ.pop(k, None)
    prof.pop("top_host_ops", None)
    return {"backend": backend, "max_abs_loss_diff": d_loss,
            "max_abs_grad_diff": d_grad, "agreement": agree,
            "steps_per_s": steps / wall, "launches": counts,
            "per_step": {k: v // steps for k, v in counts.items()},
            "allreduce_ms": ar_ms, "allreduce_profile": ar_prof,
            "gradients": n_grad, "peak_memory_bytes": peak, "last": last,
            "profile": prof}


def spawn_ranks(job: str, root: str, n: int = 2) -> list[dict]:
    """``n`` ranks of ``rank_worker(job)`` (this script with
    ``--rank-worker``) on the one card, a gloo group through a file
    rendezvous under ``root``; waits for all (DDP_TIMEOUT), kills the rest
    when one fails, and returns each rank's JSON result."""
    rdv = os.path.join(root, f"{job}.rendezvous")
    logs = [open(os.path.join(root, f"{job}.rank{r}.log"), "w")
            for r in range(n)]
    env = {k: v for k, v in os.environ.items() if k not in DDP_RANK_ENV}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank-worker", job,
         str(r), str(n), rdv, root], stdout=log, stderr=subprocess.STDOUT,
        env=env, cwd=ROOT) for r, log in enumerate(logs)]
    deadline = time.monotonic() + DDP_TIMEOUT
    failed = None
    try:
        while any(p.poll() is None for p in procs) and failed is None:
            failed = next((r for r, p in enumerate(procs)
                           if p.poll() not in (None, 0)), None)
            if time.monotonic() > deadline:
                failed = "timeout"
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    for r in range(n):
        with open(os.path.join(root, f"{job}.rank{r}.log")) as f:
            tail = f.read()[-3000:]
        if failed is not None or procs[r].returncode != 0:
            print(f"--- {job} rank {r} (exit {procs[r].returncode}):\n{tail}",
                  flush=True)
    if failed is not None or any(p.returncode != 0 for p in procs):
        fail(f"{job}: a rank failed ({failed})")
    out = []
    for r in range(n):
        with open(os.path.join(root, f"{job}.rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _svqa_ddp_config() -> dict:
    """config/kwai_simpleVQA.yml's model and schedule in float32, ddp on."""
    cfg = {k: v for k, v in svqa_config().items() if k != "data"}
    cfg = json.loads(json.dumps(cfg))
    cfg["model"]["compute_dtype"] = "float32"
    return dict(cfg, ddp=True)


def _svqa_ddp_batches(b: int) -> list[dict]:
    """The two-rank cell's batches of 2 x ``b`` (rank r takes rows r*b to
    (r+1)*b), the same in every process."""
    rng = np.random.default_rng(DDP_SEED)
    return [make_svqa_batch(rng, i, 2 * b) for i in range(SVQA_DDP_STEPS + 1)]


def _grad_gaps(want: dict, got: dict) -> tuple:
    """Each gradient's max|d| over its tensor's largest magnitude, the
    scale floored at GRAD_FLOOR of the model's largest gradient (PLCC is
    blind to a shift of the scores, so the head's biases, Linear ->
    Linear, have gradient 0 and hold only roundoff): (the rows (ratio,
    name, max|want|), worst first, the floor, how many were floored)."""
    floor = GRAD_FLOOR * max(g.abs().max().item() for g in want.values())
    if not floor > 0:
        fail("every gradient of the reference is 0")
    rows = sorted((((got[n] - g).abs().max().item()
                    / max(g.abs().max().item(), floor)), n,
                   g.abs().max().item()) for n, g in want.items())[::-1]
    return rows, floor, sum(m < floor for _, _, m in rows)


def _show(rows) -> list:
    return [(float(f"{r:.3g}"), n, float(f"{m:.3g}")) for r, n, m in rows]


def _svqa_f64_batch() -> dict:
    """The float64 check's batch: 2 x SVQA_F64_B videos of SVQA_F64_T
    frames at 448x448 (the views' own scale, up to ~1113)."""
    return make_svqa_batch(np.random.default_rng(DDP_SEED + 1), 0,
                           2 * SVQA_F64_B, t=SVQA_F64_T)


def _svqa_f64_grads(cfg: dict, init: dict, batch: dict, parts: list,
                    ddp: bool = False) -> dict:
    """Float64 gradients of SimpleVQA from the state ``init``: the mean of
    total_loss over the row slices ``parts`` of ``batch``; with ``ddp``
    through the DDP step's pieces (synced BatchNorm, the state broadcast,
    the gradient all-reduce)."""
    import torch

    from kvq_tpu_torch.models.vqa_network import VQANetwork
    from kvq_tpu_torch.nn.resnet import sync_batchnorm
    from kvq_tpu_torch.parallel.steps import broadcast_state, reduce_gradients
    from kvq_tpu_torch.train.losses import total_loss

    with torch.device("cuda", torch.cuda.current_device()):
        net = VQANetwork(cfg)
    net.load_state_dict(init)
    net = net.double().train()
    if ddp:
        sync_batchnorm(net)
        broadcast_state(net)
    dev = {k: torch.from_numpy(np.asarray(batch[k])).cuda().double()
           for k in ("simpleVQA", "feat", "label")}
    scores = net(dev)[0]
    loss = sum(total_loss([scores[p]], dev["label"][p], None)[0]
               for p in parts) / len(parts)
    loss.backward()
    if ddp:
        reduce_gradients(net.parameters())
    return {n: p.grad.cpu() for n, p in net.named_parameters()}


def svqa_ddp_path(card: str) -> dict:
    """(b) SimpleVQA training at the config's per-rank B=4, T=8, 448x448 on
    two gloo ranks sharing the one card, the BatchNorms synced, in float32
    with TF32 off: the first step against a one-process emulation on the
    card (one B=8 forward in train mode, the mean of the two halves'
    total_loss): the loss within SVQA_TRAIN_TOL relative, each running
    statistic within SVQA_TRAIN_TOL of its tensor's largest magnitude, each
    reduced gradient within TRAIN_GRAD_TOL; then SVQA_DDP_STEPS timed
    steps, after which the ranks' parameters must be bit-equal.  The same
    step's pieces in float64 (per rank B=SVQA_F64_B, T=SVQA_F64_T) against
    a float64 emulation: each reduced gradient within SVQA_F64_TOL.  In
    f32 this network's gradients at the views' scale sit percents from
    f64 on one process already (PERF.md §6): f64 is where the
    step's gradient is held tight."""
    import torch

    from kvq_tpu_torch.train.losses import total_loss
    from kvq_tpu_torch.train.trainer import Trainer

    t_phase = time.time()
    cfg = _svqa_ddp_config()
    b = int(cfg["batch_size"])
    batch = _svqa_ddp_batches(b)[0]
    root = tempfile.mkdtemp(prefix="kvq_ddp_svqa_")
    with tf32(False):
        te = Trainer(cfg, device="cuda", seed=0, steps_per_epoch=100)
        init = {k: v.cpu() for k, v in te.model.state_dict().items()}
        torch.save(init, os.path.join(root, "init.pt"))
        _, host = te._prepare(batch)
        dev = {k: v.cuda() for k, v in host.items()}
        te.model.train()
        scores = te.model(dev, gen=te.gen)[0]
        halves = [total_loss([scores[r * b:(r + 1) * b]],
                             dev["label"][r * b:(r + 1) * b], None)[0]
                  for r in range(2)]
        loss = (halves[0] + halves[1]) / 2
        loss.backward()
        emu_loss = loss.item()
        emu_grads = {n: p.grad.cpu() for n, p in te.model.named_parameters()}
        emu_stats = {n: (m.cpu(), v.cpu(), k)
                     for n, (m, v, k) in _bn_stats(te.model).items()}
    del te, dev, host, scores, halves, loss
    torch.cuda.empty_cache()
    fb = SVQA_F64_B
    emu64 = _svqa_f64_grads(cfg, init, _svqa_f64_batch(),
                            [slice(0, fb), slice(fb, 2 * fb)])
    torch.cuda.empty_cache()
    ranks = spawn_ranks("svqa_train", root)
    r0 = ranks[0]
    got = torch.load(os.path.join(root, "svqa_train.rank0.pt"))
    gap = _stats_gap(emu_stats, got["stats"])
    rel, floor, floored = _grad_gaps(emu_grads, got["grads"])
    rel64, floor64, floored64 = _grad_gaps(emu64, got["grads64"])
    dl = abs(r0["loss"] - emu_loss)
    equal = [r["params_equal_rank0"] for r in ranks]
    sps = min(r["steps_per_s"] for r in ranks)
    print(f"SimpleVQA DDP (2 gloo ranks on one card, synced BatchNorm, f32, "
          f"TF32 off, B={b} a rank, T={SVQA_T}, {SVQA_CROP}x{SVQA_CROP}) vs a "
          f"one-process B={2 * b} emulation: loss {r0['loss']:.7f} vs "
          f"{emu_loss:.7f}, |d| {dl:.3g} (tol "
          f"{SVQA_TRAIN_TOL * abs(emu_loss):.3g}); running statistics, worst "
          f"max|d| / max|emu| of a tensor {gap['per_tensor']:.3g} at "
          f"{gap['per_tensor_at']} (tol {SVQA_TRAIN_TOL}); reduced f32 "
          f"gradients, max|d| / max(max|emu|, {GRAD_FLOOR} x the largest = "
          f"{floor:.3g}), {floored} of {len(rel)} floored, worst three "
          f"(ratio, name, max|emu|) {_show(rel[:3])} (tol {TRAIN_GRAD_TOL}); "
          f"in f64 (B={fb} a rank, T={SVQA_F64_T}), floor {floor64:.3g}, "
          f"{floored64} floored, worst three {_show(rel64[:3])} (tol "
          f"{SVQA_F64_TOL}); after {SVQA_DDP_STEPS + 1} steps the ranks' "
          f"parameters bit-equal: {equal}; {SVQA_DDP_STEPS} steps at "
          f"{sps:.3f} steps/s, two ranks sharing one card (not a scaling "
          f"figure); peak memory a rank "
          f"{[round(r['peak_memory_bytes'] / 2 ** 30, 3) for r in ranks]} "
          f"GiB; {card}", flush=True)
    if not dl <= SVQA_TRAIN_TOL * abs(emu_loss):
        fail("SimpleVQA DDP: the loss disagrees with the emulation")
    if not gap["per_tensor"] <= SVQA_TRAIN_TOL:
        fail("SimpleVQA DDP: the running statistics disagree")
    if not rel[0][0] <= TRAIN_GRAD_TOL:
        fail("SimpleVQA DDP: the reduced f32 gradients disagree")
    if not rel64[0][0] <= SVQA_F64_TOL:
        fail("SimpleVQA DDP: the reduced f64 gradients disagree")
    if not all(equal):
        fail("SimpleVQA DDP: the ranks' parameters differ")
    shutil.rmtree(root)
    phase_s = time.time() - t_phase
    print(f"SimpleVQA DDP phase: {phase_s:.1f} s", flush=True)
    return {"loss": r0["loss"], "loss_emulation": emu_loss,
            "loss_abs_diff": dl, "stats_gap": gap, "grad_worst": rel[:8],
            "grad_f64_worst": rel64[:8], "params_equal": equal,
            "steps_per_s": sps, "ranks": ranks, "phase_s": phase_s}


def _ksvqe_files_config(files: dict, root: str) -> dict:
    """config/Kwai_KSVQE.yml's model and schedule (ddp on) over mp4 files of
    the SimpleVQA files cell: 8 train videos and the 16 val ones."""
    def split(name, rows, phase, view):
        with open(os.path.join(root, f"{name}.txt"), "w") as f:
            f.writelines(f"{n},{i % 3},{i % 4},{s}\n"
                         for i, (n, s) in enumerate(rows))
        return {"type": "ViewDecompositionDataset_KVQ", "args": {
            "phase": phase, "anno_file": os.path.join(root, f"{name}.txt"),
            "data_prefix": files["videos"],
            "sample_types": {"technical": dict(view)}}}

    return {**json.loads(json.dumps(TRAIN_CONFIG)), "ddp": True,
            "num_workers": 6, "data": {
                "train": split("train", files["splits"]["train"][:8],
                               "train", TRAIN_VIEW),
                "val": split("val", files["splits"]["val"], "test",
                             VAL_VIEW)}}


def cli_ddp_path(card: str, files: dict) -> dict:
    """(c) KSVQE scoring through ``cli.test.run`` on two gloo ranks sharing
    the one card, over the 16 val mp4s of the SimpleVQA files cell (seeded
    weights): rank 0's output.txt has the one-process run's names in the
    same order, the scores within SCORE_TOL; K1 and K2 run in each rank's
    forwards."""
    from kvq_tpu_torch.cli import test as cli_test

    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="kvq_ddp_cli_")
    cfg = _ksvqe_files_config(files, root)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(cfg, f)
    t0 = time.perf_counter()
    ref = cli_test.run(cfg, os.path.join(root, "ref.txt"), device="cuda")
    one_s = time.perf_counter() - t0
    ranks = spawn_ranks("cli_test", root)
    with open(os.path.join(root, "output.txt")) as f:
        lines = [ln.rsplit(",", 1) for ln in f.read().splitlines()]
    names = [n for n, _ in lines]
    diffs = [abs(float(s) - r) for (_, s), (_, r) in zip(lines, ref)]
    n = len(ref)
    per_rank = -(-n // 2)  # each rank's forwards: its shard of the list
    wall = max(r["wall_s"] for r in ranks)
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    print(f"cli.test.run on 2 gloo ranks sharing one card (KSVQE, {n} mp4 "
          f"files of {CLI_FRAMES} frames, {CLI_W}x{CLI_H}): output.txt "
          f"{len(lines)} rows, names in the one-process order: "
          f"{names == [m for m, _ in ref]}; scores max|d| {max(diffs):.3g} "
          f"(tol {SCORE_TOL}); {n / wall:.3f} videos/s (the slower rank's "
          f"run, {wall:.3f} s) against one process's {n / one_s:.3f}; "
          f"launches over both ranks ({per_rank} forwards each) {launches}; "
          f"{card}", flush=True)
    if names != [m for m, _ in ref] or os.path.exists(
            os.path.join(root, "output.rank1.txt")):
        fail("cli.test on 2 ranks: output.txt is not the one-process one")
    if not max(d / (SCORE_TOL * max(1.0, abs(r)))
               for d, (_, r) in zip(diffs, ref)) <= 1.0:
        fail("cli.test on 2 ranks: the scores disagree")
    if launches != dict(NO_LAUNCHES, fused_swin_block=12 * 2 * per_rank,
                        flash_attention_nobias_cl=9 * 2 * per_rank):
        fail(f"cli.test on 2 ranks: expected 12 K1 + 9 K2 a forward, got "
             f"{launches}")
    shutil.rmtree(root)
    phase_s = time.time() - t_phase
    print(f"cli.test DDP phase: {phase_s:.1f} s", flush=True)
    return {"videos_per_s": n / wall, "one_process_videos_per_s": n / one_s,
            "max_abs_score_diff": max(diffs), "launches": launches,
            "ranks": ranks, "phase_s": phase_s}


def torchrun_path(card: str, files: dict) -> dict:
    """(d) The user's launch: ``torchrun --standalone --nproc_per_node 1 -m
    kvq_tpu_torch.cli.train -o <config> --ddp`` on cli_train_path's config
    (config/Kwai_KSVQE.yml's model and schedule, ddp on) over 8 train and
    16 val mp4s, one epoch, as a subprocess; its exit code, steps/s and the
    first record of its metrics file."""
    import yaml

    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="kvq_torchrun_")
    cfg = _ksvqe_files_config(files, root)
    cfg["data"]["val"]["args"]["anno_file"] = os.path.join(root, "val4.txt")
    with open(os.path.join(root, "val.txt")) as f:
        rows = f.readlines()[:4]
    with open(os.path.join(root, "val4.txt"), "w") as f:
        f.writelines(rows)
    path = os.path.join(root, "ksvqe.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    work = os.path.join(root, "work")
    launcher = shutil.which("torchrun")
    cmd = ([launcher] if launcher else
           [sys.executable, "-m", "torch.distributed.run"]) + [
        "--standalone", "--nproc_per_node", "1", "-m",
        "kvq_tpu_torch.cli.train", "-o", path, "-r", work, "--ddp",
        "--epochs", "1", "--seed", "0", "--log_dir", work]
    env = {k: v for k, v in os.environ.items() if k not in DDP_RANK_ENV}
    log = os.path.join(ROOT, "chiprun_out", "torchrun.log")
    t0 = time.perf_counter()
    with open(log, "w") as out:
        try:
            rc = subprocess.run(cmd, stdout=out, stderr=subprocess.STDOUT,
                                env=env, cwd=ROOT,
                                timeout=DDP_TIMEOUT).returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
    wall = time.perf_counter() - t0
    with open(log) as f:
        text = f.read()
    epoch = [ln for ln in text.splitlines() if ln.startswith("epoch 0")]
    metrics = os.path.join(work, "KSVQE_metrics.jsonl")
    first = None
    if os.path.exists(metrics):
        with open(metrics) as f:
            first = json.loads(f.readline())
    files_out = sorted(os.listdir(work)) if os.path.isdir(work) else []
    if rc != 0 or first is None:
        print(text[-4000:], flush=True)
        fail(f"torchrun cli.train: exit {rc}, metrics record {first}")
    sps = first["step"] / first["time_s"]
    print(f"torchrun ({' '.join(cmd[:5])} ... -m kvq_tpu_torch.cli.train "
          f"--ddp): exit {rc} in {wall:.1f} s; files {files_out}; the first "
          f"metrics record {first}: {sps:.3f} steps/s from the Trainer built "
          f"to the epoch's losses (the Loader's fill included); its epoch "
          f"line: {epoch}; {card}", flush=True)
    shutil.rmtree(root)
    return {"exit": rc, "wall_s": wall, "first_record": first,
            "steps_per_s": sps,
            "epoch_line": epoch, "files": files_out,
            "phase_s": time.time() - t_phase}


# --------------------------------------------------------------------------
# the (data, fsdp) layout (kvq_tpu_torch/parallel/fsdp.py): KSVQE at full
# width on four gloo ranks sharing the card, data 2 x fsdp 2, the shipped
# global batch of 4 (one row a rank); its eval under the layout; the dry run

FSDP_RANKS = 4
FSDP_SEED = 21
# config/Kwai_KSVQE.yml's train config with the random parts off (QRS sigma
# 0, DropPath 0; the head's dropout is set to 0 on the model), so that the
# sharded step and the one-process step draw nothing
FSDP_CONFIG = json.loads(json.dumps(TRAIN_CONFIG))
FSDP_CONFIG["model"]["args"]["KSVQE"]["backbone"].update(
    sigma=0.0, drop_path_rate=0.0)
# the same on the plain path (no kernel), in bf16 and in float32; see
# fsdp_path
FSDP_PLAIN_CONFIG = json.loads(json.dumps(FSDP_CONFIG))
FSDP_PLAIN_CONFIG["model"]["args"]["KSVQE"]["backbone"]["use_pallas"] = False
FSDP_F32_CONFIG = json.loads(json.dumps(FSDP_PLAIN_CONFIG))
FSDP_F32_CONFIG["model"]["compute_dtype"] = "float32"
# kvq_tpu_torch/ops kernels a step a rank: K4 on stages 0-2, K5 on stage 3
FSDP_STEP_LAUNCHES = dict(NO_LAUNCHES, train_swin_block=10,
                          train_swin_block_bwd=10, window_attention_train=2,
                          window_attention_train_bwd=2)
FSDP_EVAL_LAUNCHES = dict(NO_LAUNCHES, fused_swin_block=12,
                          flash_attention_nobias_cl=9)


def _fsdp_batches() -> list[dict]:
    """The train batches (B=4 each, the same in every process)."""
    rng = np.random.default_rng(FSDP_SEED)
    return [make_train_batch(rng, i) for i in range(TRAIN_STEPS + 1)]


def _fsdp_eval_batches() -> list[dict]:
    """One eval video a rank at the shipped eval shapes, stamped with its
    dataset index."""
    rng = np.random.default_rng(FSDP_SEED + 1)
    return [dict(make_batch(rng, i), sample_index=np.asarray([i]))
            for i in range(FSDP_RANKS)]


def _equal_on_ranks(tensors) -> bool:
    """Whether this rank's tensors equal rank 0's, bit for bit."""
    import torch
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1) for t in tensors])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    return bool(torch.equal(flat, ref))


def _sharded_first_step(cfg, mesh, batch, rank, dev):
    """The model of ``cfg`` (seed 0, the head's dropout off), its sharded
    step and state, and the loss terms and whole reduced gradient of its
    first step on this rank's row of ``batch``."""
    from kvq_tpu_torch.data.pipeline import (
        train_fields,
        train_host_tensors,
        view_dtype,
    )
    from kvq_tpu_torch.models.vqa_network import build_train_model
    from kvq_tpu_torch.parallel import fsdp

    model = build_train_model(cfg, dev, seed=0)
    model.KSVQE_head.dropout_ratio = 0.0
    step, state = fsdp.make_sharded_train_step(model, cfg, mesh,
                                               steps_per_epoch=100, seed=0)
    fields, cast = train_fields(["KSVQE"]), view_dtype(cfg)

    def mine(b):
        return {k: v.to(dev) for k, v in train_host_tensors(
            {k: v[rank:rank + 1] for k, v in b.items()}, fields, cast,
            pin=dev.type == "cuda").items()}

    aux = {k: float(v) for k, v in step(state, mine(batch)).items()}
    idx = [i for i, t in enumerate(state.trainable) if t]
    grads = dict(zip((state.names[i] for i in idx), state.gather(
        [state.params[i].grad for i in idx], idx)))
    return model, step, state, mine, aux, grads


def _rank_fsdp(rank: int, root: str) -> dict:
    """One rank of the (data, fsdp) phase: the first step on the plain path
    in float32, then in bf16 (each's whole reduced gradient saved by rank
    0), then on the kernel path in bf16: the first step (its gradient
    saved), timed steps, the collectives timed alone, the state's bytes,
    the parameters compared across ranks, one sharded eval forward (rank 0
    also scores the four videos in one process), then the dry run's three
    flavours.  The first steps run with TF32 off."""
    import torch

    from kvq_tpu_torch.models.vqa_network import (
        VQANetwork,
        cast_model,
        compute_dtype,
    )
    from kvq_tpu_torch.parallel import fsdp
    from kvq_tpu_torch.parallel.dryrun import dryrun_multichip
    from kvq_tpu_torch.parallel.mesh import make_mesh
    from kvq_tpu_torch.parallel.steps import sum_flat
    from kvq_tpu_torch.train.evaluator import Evaluator

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = FSDP_CONFIG
    mesh = make_mesh(data=2, fsdp=2)
    host = _fsdp_batches()
    plain_aux, plain_counts = {}, {}
    for name, plain_cfg in (("f32", FSDP_F32_CONFIG),
                            ("plain", FSDP_PLAIN_CONFIG)):
        reset_counts()
        with tf32(False):
            out = _sharded_first_step(plain_cfg, mesh, host[0], rank, dev)
        plain_counts[name], plain_aux[name] = kernel_counts(), out[4]
        if rank == 0:
            torch.save({n: g.cpu() for n, g in out[5].items()},
                       os.path.join(root, f"fsdp.{name}.grads.pt"))
        del out
        torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with tf32(False):
        model, step, state, mine, aux, grads = _sharded_first_step(
            cfg, mesh, host[0], rank, dev)
    first = kernel_counts()
    setup_s = time.perf_counter() - t0
    if rank == 0:
        torch.save({n: g.cpu() for n, g in grads.items()},
                   os.path.join(root, "fsdp.kernel.grads.pt"))
    del grads
    batches = [mine(b) for b in host[1:]]
    idx = [i for i, t in enumerate(state.trainable) if t]

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for b in batches:
        last = step(state, b)
    last = {k: float(v) for k, v in last.items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    timed = kernel_counts()
    peak = torch.cuda.max_memory_allocated()

    shards = [state.params[i].detach() for i in idx]
    gather_ms = cuda_ms(lambda: state.gather(shards, idx), 3)
    whole = state.gather(shards, idx)
    reduce_ms = cuda_ms(lambda: sum_flat(whole), 3)
    del whole
    weights = state.whole()
    equal = _equal_on_ranks(weights.values())

    evals = _fsdp_eval_batches()
    eval_fn = fsdp.make_sharded_eval_step(model, cfg)
    reset_counts()
    index, scores, labels = eval_fn(state, [evals[rank]])
    eval_counts = kernel_counts()
    one = None
    if rank == 0:  # the same four videos in one process
        with torch.device(dev):
            net = cast_model(VQANetwork(cfg), compute_dtype(cfg)).eval()
        net.load_state_dict({**weights, **dict(model.named_buffers())})
        one = [s for _, _, p in Evaluator(cfg, model=net, device=dev)
               .scored_batches(evals) for s in p]
        del net
    del weights
    torch.cuda.empty_cache()
    dry = dryrun_multichip(FSDP_RANKS, dev, card=True)
    return {"setup_s": setup_s, "aux": aux, "aux_f32": plain_aux["f32"],
            "aux_plain": plain_aux["plain"], "plain_counts": plain_counts,
            "first_step": first,
            "timed": timed, "last": last, "steps_per_s": TRAIN_STEPS / wall,
            "gather_ms": gather_ms, "reduce_ms": reduce_ms,
            "peak_memory_bytes": peak, "state_bytes": state.state_bytes(),
            "params_equal_rank0": equal, "eval": eval_counts,
            "eval_rows": [index, scores, labels], "one_process": one,
            "dryrun": dry}


def swin2d_dropout_check(card: str) -> dict:
    """One train forward and backward of swin_2d_tiny (B=4, T=8, 224 px,
    bf16, remat off) with dropout on, counted by route: with
    ``attn_drop_rate`` > 0 no block takes K4 or K5 (the plain attention
    drops its weights); with ``drop_rate`` alone each block declines K4 and
    takes K5 (12 + 12)."""
    import torch

    from kvq_tpu_torch.models.vqa_network import cast_model
    from kvq_tpu_torch.nn.swin import swin_2d_tiny

    x = torch.randn(SWIN2D_TRAIN_B, SWIN2D_T, SWIN2D_PX, SWIN2D_PX, 3,
                    generator=torch.Generator().manual_seed(5)).cuda()
    out = {}
    for rates, want in (
            ((0.0, 0.1), {}),
            ((0.1, 0.0), {"window_attention_train": 12,
                          "window_attention_train_bwd": 12})):
        with torch.device("cuda"):
            m = swin_2d_tiny(use_pallas=True, use_checkpoint=False,
                             drop_rate=rates[0], attn_drop_rate=rates[1])
        m = cast_model(m, torch.bfloat16).train()
        reset_counts()
        loss = m(x.bfloat16(), torch.Generator("cuda").manual_seed(0)
                 ).float().square().mean()
        loss.backward()
        loss = loss.detach()
        torch.cuda.synchronize()
        counts = kernel_counts()
        if counts != dict(NO_LAUNCHES, **want) or not math.isfinite(
                float(loss)):
            fail(f"swin_2d_tiny with drop_rate, attn_drop_rate = {rates}: "
                 f"launches {counts}, loss {float(loss)}")
        out[f"drop {rates[0]}, attn_drop {rates[1]}"] = {
            "launches": counts, "loss": float(loss)}
        del m, loss
    print(f"swin_2d_tiny train step with dropout (B={SWIN2D_TRAIN_B}, "
          f"T={SWIN2D_T}, {SWIN2D_PX} px, bf16): {json.dumps(out)}; {card}",
          flush=True)
    return out


def fsdp_path(card: str) -> dict:
    """The (data, fsdp) sharded step of KSVQE at full width (bf16, B=4,
    T=32, 112 px resize views, the random parts off) on four gloo ranks on
    the one card (NCCL refuses two ranks on one GPU), TF32 off in every
    compared step: its first step in float32 on the plain path against the
    one-process Trainer step on the same 4 rows from the same weights (the
    sharded semantics: the global loss, the gradient's scale), and on the
    kernel path in bf16 against the same sharded step on the plain path in
    bf16; the loss within LOSS_TOL and all gradients together within
    TRAIN_GRAD_TOL of their norm, and in float32 each Swin gradient too (in
    bf16 each is reported: see below); no launch on the plain path, K4
    10 + 10 and K5 2 + 2 a step a rank on the kernel path, the ranks'
    gathered parameters bit-equal after the timed steps, one sharded eval
    forward with 12 K1 + 9 K2 a rank and its gathered scores within
    SCORE_TOL of one process's; steps/s, the collectives' ms, each rank's
    peak memory and sharded-state bytes beside the DDP route's; the dry
    run's three flavours at 4 ranks (the card's block geometry); then
    swin_2d_tiny trained with dropout, by route."""
    import torch

    from kvq_tpu_torch.train.trainer import Trainer

    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="kvq_fsdp_")
    with tf32(False):
        tr = Trainer(FSDP_F32_CONFIG, device="cuda", seed=0,
                     steps_per_epoch=100)
        tr.model.KSVQE_head.dropout_ratio = 0.0
        one_aux = tr.train_step(_fsdp_batches()[0])
    one_grads = {n: p.grad.float().cpu() for n, p in
                 tr.model.named_parameters() if p.grad is not None}
    del tr
    torch.cuda.empty_cache()
    ranks = spawn_ranks("fsdp", root, FSDP_RANKS)
    r0 = ranks[0]

    def grads(name):
        return torch.load(os.path.join(root, f"fsdp.{name}.grads.pt"))

    agree = {
        "f32": grad_agreement(
            "(data, fsdp) step (4 gloo ranks) vs the one-process step, "
            "f32, plain path", grads("f32"), one_grads, r0["aux_f32"],
            one_aux, "KSVQE_backbone.layers."),
        "bf16": grad_gaps(
            "(data, fsdp) step (4 gloo ranks), bf16, kernel path vs plain "
            "path (each gradient reported)", grads("kernel"),
            grads("plain"), r0["aux"], r0["aux_plain"],
            "KSVQE_backbone.layers.")}
    del one_grads
    # In bf16 the loss and all gradients together are held; each gradient
    # is not: the PLCC over four scores 0.04 apart turns the bf16 rounding
    # of the scores into a gap of ~0.1 in every Swin gradient alike, on
    # either path (PERF.md §6).  K4 and K5 are held gradient by gradient at
    # this step's one row a rank in train_kernel_phase(batch=1).
    bf16 = agree["bf16"]
    if not (math.isfinite(r0["aux"]["total_loss"])
            and bf16["loss_abs_diff"] <= bf16["loss_tol"]
            and bf16["grad_rel_all"] <= TRAIN_GRAD_TOL):
        fail(f"(data, fsdp) bf16 step, kernel path vs plain path: loss "
             f"|d| {bf16['loss_abs_diff']}, all gradients "
             f"{bf16['grad_rel_all']}")
    steps = TRAIN_STEPS
    for r, res in enumerate(ranks):
        want = {k: v * steps for k, v in FSDP_STEP_LAUNCHES.items()}
        if (res["first_step"] != FSDP_STEP_LAUNCHES or res["timed"] != want
                or res["eval"] != FSDP_EVAL_LAUNCHES
                or any(c != NO_LAUNCHES
                       for c in res["plain_counts"].values())):
            fail(f"(data, fsdp) rank {r}: launches {res['first_step']}, "
                 f"{res['timed']} over {steps} steps, eval {res['eval']}, "
                 f"plain path {res['plain_counts']}")
        if not res["params_equal_rank0"] or any(
                res[k] != r0[k] for k in ("aux", "aux_f32", "aux_plain")):
            fail(f"(data, fsdp) rank {r}: parameters or loss differ from "
                 f"rank 0's")
        b = res["state_bytes"]
        if b["sharded"] * 2 != b["sharded_replicated"]:
            fail(f"(data, fsdp) rank {r}: sharded state {b}")
    index, scores, _ = r0["eval_rows"]
    one = r0["one_process"]
    gap = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(scores, one))
    if index != list(range(FSDP_RANKS)) or not gap <= SCORE_TOL:
        fail(f"(data, fsdp) eval: rows {index}, scores {scores} vs one "
             f"process {one}")
    print(f"(data, fsdp) sharded step, KSVQE at full width on "
          f"{FSDP_RANKS} gloo ranks (data 2 x fsdp 2, one row a rank, bf16):"
          f" {r0['steps_per_s']:.3f} steps/s (rank 0; ranks "
          f"{[round(r['steps_per_s'], 3) for r in ranks]}) over {steps} "
          f"steps; the collectives alone (CUDA events, rank 0): all-gather "
          f"of the trainable shards {r0['gather_ms']:.2f} ms, the gradient "
          f"all-reduce {r0['reduce_ms']:.2f} ms; peak memory a rank "
          f"{[round(r['peak_memory_bytes'] / 2 ** 30, 3) for r in ranks]} "
          f"GiB; f32 masters, moments and EMA a rank: sharded parameters "
          f"{r0['state_bytes']['sharded'] / 2 ** 20:.1f} MiB against "
          f"{r0['state_bytes']['sharded_replicated'] / 2 ** 20:.1f} "
          f"replicated (the DDP route), all parameters "
          f"{r0['state_bytes']['total'] / 2 ** 20:.1f} against "
          f"{r0['state_bytes']['total_replicated'] / 2 ** 20:.1f} MiB; "
          f"launches a step a rank {FSDP_STEP_LAUNCHES['train_swin_block']}"
          f" + {FSDP_STEP_LAUNCHES['train_swin_block_bwd']} K4, "
          f"{FSDP_STEP_LAUNCHES['window_attention_train']} + "
          f"{FSDP_STEP_LAUNCHES['window_attention_train_bwd']} K5; eval "
          f"12 K1 + 9 K2 a rank, gathered scores {scores} vs one process "
          f"{one} (max rel gap {gap:.3g}, tol {SCORE_TOL}); the ranks' "
          f"parameters bit-equal; setup and first step "
          f"{r0['setup_s']:.1f} s; last losses {r0['last']}; dry run "
          f"{json.dumps(r0['dryrun'])}; {card}",
          flush=True)
    dropout = swin2d_dropout_check(card)
    shutil.rmtree(root, ignore_errors=True)
    print(f"(data, fsdp) phase: {time.time() - t_phase:.1f} s", flush=True)
    return {"agreement": agree, "ranks": ranks, "swin2d_dropout": dropout,
            "launches_rank0": {k: r0["timed"][k] + r0["eval"][k]
                               for k in r0["timed"]},
            "phase_s": time.time() - t_phase}


def rank_worker(argv) -> int:
    """One rank of a multi-rank phase: ``JOB RANK WORLD RENDEZVOUS ROOT``.
    Joins the gloo group on cuda:0, runs the job, writes
    ``ROOT/JOB.rank{RANK}.json``."""
    import torch
    import torch.distributed as dist

    from kvq_tpu_torch.parallel import init_distributed

    job, rank, world, rdv, root = argv
    os.environ.update(RANK=rank, WORLD_SIZE=world, LOCAL_RANK=rank)
    init_distributed("cuda:0", backend="gloo", init_method=f"file://{rdv}")
    try:
        out = {"svqa_train": _rank_svqa_train, "cli_test": _rank_cli_test,
               "fsdp": _rank_fsdp}[job](int(rank), root)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"{job}.rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.cuda.synchronize()
    return 0


def _rank_svqa_train(rank: int, root: str) -> dict:
    import torch
    import torch.distributed as dist

    from kvq_tpu_torch.train.trainer import Trainer

    cfg = _svqa_ddp_config()
    b = int(cfg["batch_size"])
    mine = [{k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}
            for batch in _svqa_ddp_batches(b)]
    with tf32(False):
        tr = Trainer(cfg, device="cuda:0", seed=0, steps_per_epoch=100)
        tr.model.load_state_dict(torch.load(os.path.join(root, "init.pt")))
        torch.cuda.reset_peak_memory_stats()
        aux = tr.train_step(mine[0])
        stats = {n: (m.cpu(), v.cpu(), k)
                 for n, (m, v, k) in _bn_stats(tr.model).items()}
        grads = {n: p.grad.cpu() for n, p in tr.model.named_parameters()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = tr.train_epoch(mine[1:])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    flat = torch.cat([p.detach().reshape(-1) for p in tr.params])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    equal = bool(torch.equal(flat, ref))
    del tr, flat, ref
    torch.cuda.empty_cache()
    fb = SVQA_F64_B
    init = torch.load(os.path.join(root, "init.pt"))
    rows = slice(rank * fb, (rank + 1) * fb)
    grads64 = _svqa_f64_grads(cfg, init, {k: v[rows] for k, v in
                                          _svqa_f64_batch().items()},
                              [slice(0, fb)], ddp=True)
    if rank == 0:
        torch.save({"stats": stats, "grads": grads, "grads64": grads64},
                   os.path.join(root, "svqa_train.rank0.pt"))
    return {"loss": aux["total_loss"], "last": last,
            "steps_per_s": SVQA_DDP_STEPS / wall,
            "params_equal_rank0": equal, "peak_memory_bytes": peak}


def _rank_cli_test(rank: int, root: str) -> dict:
    from kvq_tpu_torch.cli import test as cli_test

    with open(os.path.join(root, "config.json")) as f:
        cfg = json.load(f)
    out = os.path.join(root, "output.txt" if rank == 0 else
                       f"output.rank{rank}.txt")
    reset_counts()
    t0 = time.perf_counter()
    results = cli_test.run(cfg, out, device="cuda:0")
    wall = time.perf_counter() - t0
    return {"wall_s": wall, "results": len(results),
            "launches": kernel_counts()}


# --------------------------------------------------------------------------
# the rest of the model surface: swin_2d_tiny's kernel geometries (K1 and K4
# at windows of (1, 7, 7), N = 49), the two-branch swin_tiny + conv_tiny
# model, swin_2d_tiny eval and training, and the full CLIP

# swin_2d_tiny at B=1, T=8, 224 px: (1, 4, 4) patches give 8x56x56 tokens,
# windows of (1, 7, 7) (N = 49, head_dim 32) divide every stage; at stage 3
# (7x7 tokens) get_window_size zeroes the shift
SWIN2D_T, SWIN2D_PX = 8, 224
SWIN2D_WINDOW = (1, 7, 7)
SWIN2D_STAGES = [  # (dims after patch embed/merges, C, heads, frag bias)
    ((8, 56, 56), 96, 3, False),
    ((8, 28, 28), 192, 6, False),
    ((8, 14, 14), 384, 12, False),
    ((8, 7, 7), 768, 24, False),
]
# (stage, shifted, calls of that geometry per forward): depths (2, 2, 6, 2)
SWIN2D_CASES = [(0, False, 1), (0, True, 1), (1, False, 1), (1, True, 1),
                (2, False, 3), (2, True, 3), (3, False, 2)]
SWIN2D_TRAIN_B = 4
# the two-branch model's views (FAST-VQA / DOVER sizes): the technical
# view's 7x7 fragments of 32 px and the aesthetic view, 32 frames of 224 px
DOVER_T, DOVER_PX = 32, 224
DOVER_FORWARDS = 8   # timed forwards of each videos/s run
CONV_TOL = 1e-3      # conv_tiny's f32 score, card (TF32 off) vs CPU
CLIP_TOL = 1e-3      # the full CLIP's f32 logits, card (TF32 off) vs CPU,
#                      x max|CPU logit|
# the tiny synthetic BPE of tests/test_clip_full.py and eight prompts
CLIP_MERGES = [("l", "l"), ("h", "e"), ("he", "ll"), ("hell", "o</w>"),
               ("w", "o"), ("wo", "r"), ("wor", "l"), ("worl", "d</w>")]
CLIP_TEXTS = ["hello world", "hello", "world", "a hello world video",
              "blurry world", "sharp hello", "hello hello world",
              "noisy video of the world"]


def swin2d_kernel_phase(card: str):
    """K1 at swin_2d_tiny's four stage geometries (B=1, T=8, 224 px: N =
    49), stages 0-2 unshifted and shifted, stage 3 unshifted, and K4
    forward and backward at the same geometries at B=4, against their
    plain versions; returns the records of the calls of one forward / one
    train step."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(14)
    t0 = time.time()
    k1 = {"ms": 0.0, "plain_ms": 0.0, "bound": [0.0, 0.0], "err": 0.0,
          "rows": []}
    for stage, shifted, reps in SWIN2D_CASES:
        k1_case(k1, "swin_2d_tiny", stage, shifted, gen, SWIN2D_STAGES,
                SWIN2D_WINDOW, 1, reps, card)
    k4f, k4b = _agg(), _agg()
    for stage, shifted, reps in SWIN2D_CASES:
        k4_case(k4f, k4b, "K4 swin_2d_tiny", stage, shifted, gen,
                SWIN2D_STAGES, SWIN2D_WINDOW, SWIN2D_TRAIN_B, reps, card)
    print(f"swin_2d_tiny kernel phase (N=49): K1 {k1['ms']:.4f} ms a forward "
          f"(plain {k1['plain_ms']:.4f}, bound {max(k1['bound']):.4f}); K4 "
          f"{k4f['ms']:.4f} + {k4b['ms']:.4f} ms a step (plain "
          f"{k4f['plain_ms']:.4f} + {k4b['plain_ms']:.4f}, bounds "
          f"{max(k4f['bound']):.4f} + {max(k4b['bound']):.4f}); "
          f"{time.time() - t0:.1f} s; {card}", flush=True)
    return k1, k4f, k4b


def _dover_family(name: str) -> str:
    if "depthwise" in name.lower():
        return "depthwise conv"
    return _family(name)


def _videos_per_s(model, host_batch, n: int) -> float:
    """``n`` forwards, each from a pinned host batch (copy and forward),
    over the wall clock."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(n):
            model({k: v.cuda(non_blocking=True) for k, v in
                   host_batch.items()}, reduce_scores=True)
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def _dwconv_ms(backbone, dev_shape, card: str) -> dict:
    """The depthwise (k, 7, 7) convs of one ConvNeXt forward alone, at
    their shapes (bf16, channels-last), timed with CUDA events, beside
    their bound: as the port runs them (``conv_cl``: a contiguous copy,
    PyTorch's depthwise kernel) and, for the record, as cuDNN runs them on
    the channels_last_3d view."""
    import torch
    import torch.nn.functional as F

    from kvq_tpu_torch.nn.convnext import conv_cl

    B, T, H, W = dev_shape
    calls, flops, nbytes = [], 0.0, 0.0
    for i, stage in enumerate(backbone.stages):
        h, w = H // (4 * 2 ** i), W // (4 * 2 ** i)
        for blk in stage:
            C = blk.dwconv.weight.shape[0]
            x = torch.randn(B, T, h, w, C, device="cuda").bfloat16()
            calls.append((blk.dwconv, x))
            k = blk.dwconv.weight[0].numel()
            flops += 2.0 * x.numel() * k
            nbytes += 2 * x.numel() * 2 + blk.dwconv.weight.numel() * 2

    def run():
        with torch.no_grad():
            for conv, x in calls:
                conv_cl(conv, x)

    def run_cudnn():
        with torch.no_grad():
            for conv, x in calls:
                F.conv3d(x.permute(0, 4, 1, 2, 3), conv.weight, conv.bias,
                         conv.stride, conv.padding, conv.dilation,
                         conv.groups)

    ms = cuda_ms(run, 10)
    cudnn_ms = cuda_ms(run_cudnn, 3)
    b, by = bound_ms(nbytes, flops)
    print(f"conv_tiny's {len(calls)} depthwise convs alone: {ms:.4f} ms a "
          f"forward as the port runs them (contiguous, PyTorch's depthwise "
          f"kernel), {cudnn_ms:.4f} ms through cuDNN on the "
          f"channels_last_3d view; bound {b:.4f} ms ({by}); {card}",
          flush=True)
    return {"ms": ms, "cudnn_channels_last_ms": cudnn_ms, "bound_ms": b,
            "bound_by": by, "calls": len(calls)}


def dover_path(card: str) -> dict:
    """The two-branch model "swin_tiny,conv_tiny" (DOVER's technical +
    aesthetic layout) at full width, bf16, use_pallas, scores summed under
    reduce_scores: B=1, technical and aesthetic views of 32 frames at 224
    px.  Videos/s and its spread, the host's dispatch, the device's busy
    time by family (the depthwise conv on its own line), launch calls,
    idle share, peak memory, K1 launches per forward; the kernel path
    against the plain path; conv_tiny alone in f32 (TF32 off) against the
    CPU."""
    import torch

    from kvq_tpu_torch.models.vqa_network import build_model

    t_phase = time.time()
    config = keys_config(["swin_tiny", "conv_tiny"])
    model = build_model(config, device="cuda", seed=3)
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(14)
    shape = (1, DOVER_T, DOVER_PX, DOVER_PX, 3)
    batch = {"technical": rng.standard_normal(shape, dtype=np.float32),
             "asesthetic": rng.standard_normal(shape, dtype=np.float32)}
    # host_tensors takes the Loader's keys, which hold no "asesthetic" (in
    # kvq_tpu as in the port): the model is fed at its own level
    host = {k: torch.from_numpy(v).to(torch.bfloat16).pin_memory()
            for k, v in batch.items()}
    dev = {k: v.cuda() for k, v in host.items()}
    with torch.no_grad():
        model(dev, reduce_scores=True)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        scores = model(dev)
        score = float(sum(scores).float().reshape(()))
    torch.cuda.synchronize()
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"two-branch swin_tiny + conv_tiny: {n_params} parameters, bf16, "
          f"seeded random weights; branch scores "
          f"{[float(s.float().reshape(())) for s in scores]}, sum {score:.6f};"
          f" launches of one forward {launches}; peak memory "
          f"{peak / 2 ** 30:.3f} GiB; {card}", flush=True)
    if not math.isfinite(score):
        fail("two-branch score not finite")
    if launches["fused_swin_block"] + launches[
            "flash_window_attention_packed"] != 12 or any(
            v for k, v in launches.items() if k not in (
                "fused_swin_block", "flash_window_attention_packed")):
        fail(f"two-branch: expected one K1 or K3 launch per Swin block, got "
             f"{launches}")
    if not launches["fused_swin_block"]:
        fail("two-branch: the swin_tiny branch launched no K1")
    vps = [_videos_per_s(model, host, DOVER_FORWARDS) for _ in range(3)]
    print(f"two-branch: videos/s over {DOVER_FORWARDS} forwards (host batch "
          f"copied each time), 3 runs: {[round(v, 3) for v in vps]}; {card}",
          flush=True)
    sk, sp = _score_both(config, model, dev)
    prof = forward_timings(model, dev, 1e3 / min(vps), card, _dover_family)
    dw = _dwconv_ms(model.conv_tiny_backbone,
                    (1, DOVER_T // 2, DOVER_PX, DOVER_PX), card)

    # conv_tiny alone in f32, the card with TF32 off against the CPU
    conv_cfg = keys_config(["conv_tiny"])
    conv_cfg["model"]["compute_dtype"] = "float32"
    sd = {k: v for k, v in model.state_dict().items()
          if k.startswith("conv_tiny_")}
    x32 = {"asesthetic": torch.from_numpy(batch["asesthetic"])}
    t0 = time.time()
    with torch.no_grad():
        cpu = float(build_model(conv_cfg, device="cpu", state_dict=sd)(
            x32, reduce_scores=True).reshape(()))
    cpu_s = time.time() - t0
    gpu32 = build_model(conv_cfg, device="cuda", state_dict=sd)
    with tf32(False), torch.no_grad():
        gpu = float(gpu32({k: v.cuda() for k, v in x32.items()},
                          reduce_scores=True).reshape(()))
    d, tol = abs(gpu - cpu), CONV_TOL * max(1.0, abs(cpu))
    print(f"conv_tiny f32 score on the card (TF32 off) {gpu:.7f} vs the CPU "
          f"{cpu:.7f} ({cpu_s:.1f} s): |d| {d:.3g} (tol {tol:.3g})",
          flush=True)
    if not d <= tol:
        fail("conv_tiny's f32 score on the card disagrees with the CPU's")
    del gpu32, model, dev
    torch.cuda.empty_cache()
    phase_s = time.time() - t_phase
    print(f"two-branch phase: {phase_s:.1f} s", flush=True)
    prof.pop("top_host_ops", None)
    prof.update(videos_per_s=vps, launches=launches, peak_memory_bytes=peak,
                n_params=n_params, score=score, score_kernel=sk,
                score_plain=sp, dwconv=dw, conv_f32_card=gpu,
                conv_f32_cpu=cpu, conv_abs_diff=d, phase_s=phase_s)
    return prof


def _features_both(config, model, dev_batch, key, what):
    """The backbone features of the kernel path against the plain path's,
    within SCORE_TOL of the plain features' largest magnitude."""
    import torch

    from kvq_tpu_torch.models.vqa_network import build_model

    plain_cfg = json.loads(json.dumps(config))
    plain_cfg["model"]["args"][key]["backbone"]["use_pallas"] = False
    plain = build_model(plain_cfg, device="cuda",
                        state_dict=model.state_dict())
    with torch.no_grad():
        fk = getattr(model, f"{key}_backbone")(dev_batch).float()
        fp = getattr(plain, f"{key}_backbone")(dev_batch).float()
    d = (fk - fp).abs().max().item()
    tol = SCORE_TOL * max(1.0, fp.abs().max().item())
    print(f"{what}: features {tuple(fk.shape)} kernel path vs plain path "
          f"max|d| {d:.4g} (tol {tol:.4g})", flush=True)
    if not (math.isfinite(d) and d <= tol):
        fail(f"{what}: kernel-path features disagree with the plain path")
    del plain
    torch.cuda.empty_cache()
    return d


def swin2d_path(card: str) -> dict:
    """swin_2d_tiny + VQAHead at full width, bf16, use_pallas: eval at B=1,
    T=8, 224 px (K1 launches per forward, features and score against the
    plain path, timings); then one train step at B=4 through Trainer (f32
    masters, bf16 compute, functional_call; remat off) against the plain
    path's step, its K4 and K5 launches by route, and its timings."""
    import torch

    from kvq_tpu_torch.data.pipeline import host_tensors
    from kvq_tpu_torch.models.vqa_network import build_model
    from kvq_tpu_torch.train.trainer import Trainer

    t_phase = time.time()
    key = "swin_2d_tiny"
    config = keys_config([key])
    model = build_model(config, device="cuda", seed=4)
    rng = np.random.default_rng(15)
    x = rng.standard_normal((1, SWIN2D_T, SWIN2D_PX, SWIN2D_PX, 3),
                            dtype=np.float32)
    host = host_tensors({"technical": x}, torch.bfloat16, pin=True)
    dev = {k: v.cuda() for k, v in host.items()}
    with torch.no_grad():
        model(dev, reduce_scores=True)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        score = float(model(dev, reduce_scores=True).float().reshape(()))
    torch.cuda.synchronize()
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"swin_2d_tiny eval: score {score:.6f}; launches of one forward "
          f"{launches}; peak memory {peak / 2 ** 30:.3f} GiB; {card}",
          flush=True)
    if not math.isfinite(score):
        fail("swin_2d_tiny score not finite")
    if launches != dict(NO_LAUNCHES, fused_swin_block=12):
        fail(f"swin_2d_tiny: expected 12 K1 launches per forward and no "
             f"other kernel, got {launches}")
    vps = [_videos_per_s(model, host, DOVER_FORWARDS) for _ in range(3)]
    print(f"swin_2d_tiny eval: videos/s over {DOVER_FORWARDS} forwards, 3 "
          f"runs: {[round(v, 3) for v in vps]}; {card}", flush=True)
    feat_d = _features_both(config, model, dev, key, "swin_2d_tiny eval")
    sk, sp = _score_both(config, model, dev)
    prof = forward_timings(model, dev, 1e3 / min(vps), card)
    prof.pop("top_host_ops", None)
    prof.update(videos_per_s=vps, launches=launches, peak_memory_bytes=peak,
                feature_max_abs_diff=feat_d, score_kernel=sk, score_plain=sp)
    del model, dev
    torch.cuda.empty_cache()

    # one train step, kernel path against plain path, the same weights,
    # batch and generator seed
    train_cfg = {**config, **SCHEDULE, "batch_size": SWIN2D_TRAIN_B}
    plain_cfg = json.loads(json.dumps(train_cfg))
    plain_cfg["model"]["args"][key]["backbone"]["use_pallas"] = False
    batch = {"technical": rng.standard_normal(
        (SWIN2D_TRAIN_B, SWIN2D_T, SWIN2D_PX, SWIN2D_PX, 3),
        dtype=np.float32),
        "label": rng.standard_normal(SWIN2D_TRAIN_B).astype(np.float32)}
    tk = Trainer(train_cfg, device="cuda", seed=0, steps_per_epoch=100)
    tp = Trainer(plain_cfg, device="cuda", seed=0, steps_per_epoch=100)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    aux_k = tk.train_step(batch)
    train_launches = kernel_counts()
    train_peak = torch.cuda.max_memory_allocated()
    aux_p = tp.train_step(batch)
    agree = step_agreement("swin_2d_tiny train step, kernel path vs plain "
                           "path", tk, tp, aux_k, aux_p,
                           f"{key}_backbone.layers.")
    del tp
    torch.cuda.empty_cache()
    fwd = (train_launches["train_swin_block"]
           + train_launches["window_attention_train"])
    bwd = (train_launches["train_swin_block_bwd"]
           + train_launches["window_attention_train_bwd"])
    others = {k: v for k, v in train_launches.items() if v and k not in (
        "train_swin_block", "train_swin_block_bwd", "window_attention_train",
        "window_attention_train_bwd")}
    print(f"swin_2d_tiny train step (B={SWIN2D_TRAIN_B}, T={SWIN2D_T}, "
          f"{SWIN2D_PX} px, remat off): launches by route: K4 "
          f"{train_launches['train_swin_block']} + "
          f"{train_launches['train_swin_block_bwd']}, K5 "
          f"{train_launches['window_attention_train']} + "
          f"{train_launches['window_attention_train_bwd']}; peak memory "
          f"{train_peak / 2 ** 30:.3f} GiB; {card}", flush=True)
    if fwd != 12 or bwd != 12 or others:
        fail(f"swin_2d_tiny train: expected one K4 or K5 forward and "
             f"backward per block, got {train_launches}")
    steps = []  # end to end: host pre-cast, copy, step, readback
    for _ in range(3):
        t0 = time.perf_counter()
        tk.train_step(batch)
        steps.append(time.perf_counter() - t0)
    print(f"swin_2d_tiny train: 3 more steps through train_step, "
          f"{[round(x * 1e3, 2) for x in steps]} ms = "
          f"{[round(1 / x, 3) for x in steps]} steps/s; {card}", flush=True)
    tprof = step_timings(tk, batch, min(steps) * 1e3, card)
    tprof.pop("top_host_ops", None)
    tprof.update(launches=train_launches, peak_memory_bytes=train_peak,
                 agreement=agree, steps_per_s=[1 / x for x in steps])
    del tk
    torch.cuda.empty_cache()
    phase_s = time.time() - t_phase
    print(f"swin_2d_tiny phase: {phase_s:.1f} s", flush=True)
    return {"eval": prof, "train": tprof, "phase_s": phase_s}


def clip_configs():
    """OpenAI's published ViT-B/16 and RN50 CLIP shapes."""
    from kvq_tpu_torch.nn.clip_model import CLIPConfig

    text = dict(context_length=77, vocab_size=49408, transformer_width=512,
                transformer_heads=8, transformer_layers=12)
    return {
        "ViT-B/16": CLIPConfig(embed_dim=512, vision_width=768,
                               vision_layers=12, vision_patch_size=16,
                               image_resolution=224, **text),
        "RN50": CLIPConfig(embed_dim=1024, vision_width=64,
                           vision_layers=(3, 4, 6, 3),
                           vision_patch_size=None, image_resolution=224,
                           **text),
    }


def clip_full_path(card: str) -> dict:
    """The full CLIP at OpenAI's ViT-B/16 and RN50 shapes from seeded
    weights: 8 images of 224 px against 8 prompts (the tiny tokenizer's
    ids, padded to 77); the f32 logits on the card (TF32 off) against the
    CPU's, and a bf16 forward timed."""
    import copy

    import torch

    from kvq_tpu_torch.data.tokenizer import SimpleTokenizer, tokenize
    from kvq_tpu_torch.models.vqa_network import cast_model, init_weights
    from kvq_tpu_torch.nn.clip_model import CLIP

    t_phase = time.time()
    tok = SimpleTokenizer(merges=CLIP_MERGES)
    text = torch.from_numpy(tokenize(CLIP_TEXTS, tok, 77)).long()
    rng = np.random.default_rng(16)
    images = torch.from_numpy(rng.standard_normal((8, 224, 224, 3),
                                                  dtype=np.float32))
    out = {}
    for name, cfg in clip_configs().items():
        with torch.device("cuda"):
            net = CLIP(cfg)
        init_weights(net, seed=5)
        net.eval()
        cpu = CLIP(cfg).eval()
        cpu.load_state_dict(net.state_dict())
        t0 = time.time()
        with torch.no_grad():
            want = cpu(images, text)[0]
        cpu_s = time.time() - t0
        with tf32(False), torch.no_grad():
            got = net(images.cuda(), text.cuda())[0].cpu()
        d = (got - want).abs().max().item()
        tol = CLIP_TOL * want.abs().max().item()
        net16 = cast_model(copy.deepcopy(net), torch.bfloat16)
        img16, txt = images.cuda().bfloat16(), text.cuda()
        with torch.no_grad():
            ms16 = cuda_ms(lambda: net16(img16, txt), 10)
            g16 = net16(img16, txt)[0].float().cpu()
        n_params = sum(p.numel() for p in net.parameters())
        print(f"CLIP {name} ({n_params} parameters): f32 logits (8x8) on the "
              f"card (TF32 off) vs the CPU ({cpu_s:.1f} s): max|d| {d:.3g} "
              f"(tol {tol:.3g}); bf16 forward of 8 images and 8 prompts "
              f"{ms16:.3f} ms; the bf16 logits' max|d| to the f32 CPU's "
              f"{(g16 - want).abs().max().item():.3g} (reported); {card}",
              flush=True)
        if not (torch.isfinite(got).all() and d <= tol):
            fail(f"CLIP {name}: the card's f32 logits disagree with the "
                 f"CPU's")
        out[name] = {"max_abs_diff": d, "tol": tol, "bf16_ms": ms16,
                     "cpu_s": cpu_s, "n_params": n_params}
        del net, net16, cpu
        torch.cuda.empty_cache()
    phase_s = time.time() - t_phase
    print(f"full-CLIP phase: {phase_s:.1f} s", flush=True)
    out["phase_s"] = phase_s
    return out


def first_line(cmd) -> str:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except OSError as e:
        return f"absent ({e})"
    return (out.stdout or out.stderr).strip().splitlines()[0]


def opencv_check() -> str:
    """``ls /usr/include/opencv4; ldconfig -p | grep opencv_videoio``."""
    ls = subprocess.run(["ls", "/usr/include/opencv4"], capture_output=True,
                        text=True, timeout=60)
    ld = subprocess.run(["sh", "-c", "ldconfig -p | grep opencv_videoio"],
                        capture_output=True, text=True, timeout=60)
    headers = (f"/usr/include/opencv4: {ls.stdout.split()}"
               if ls.returncode == 0 else "no /usr/include/opencv4")
    libs = ld.stdout.split() if ld.returncode == 0 else "no libopencv_videoio"
    return f"{headers}; ldconfig: {libs}"


def build_runtime(result: dict) -> None:
    """Build (or find) the native host runtime; its time or its error in
    ``result``."""
    from kvq_tpu_torch import runtime

    t0 = time.time()
    try:
        runtime.load()
    except RuntimeError as e:
        result["error"] = str(e)
    result["s"] = time.time() - t0


def host_packages() -> str:
    """Which of the host readers the JAX package uses are installed."""
    return ", ".join(
        f"{m} {'present' if importlib.util.find_spec(m) else 'absent'}"
        for m in ("cv2", "yaml", "pandas", "openpyxl", "msgpack"))


def main() -> int:
    if sys.argv[1:2] == ["--rank-worker"]:  # a rank of a two-rank phase
        return rank_worker(sys.argv[2:])
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
    print(f"host packages: {host_packages()}", flush=True)
    print(f"host C++ compiler: {first_line(['g++', '--version'])}",
          flush=True)
    print(f"OpenCV C++ headers and videoio (for the native decoder, not "
          f"ported): {opencv_check()}", flush=True)
    t0 = time.time()
    runtime_build = {}
    build_thread = threading.Thread(target=build_runtime,
                                    args=(runtime_build,))
    build_thread.start()
    reports = build.build_all()
    build_thread.join()
    if "error" in runtime_build:
        fail(f"the native runtime did not build: {runtime_build['error']}")
    print(f"build: {time.time() - t0:.1f} s (CUDA kernels; the native "
          f"runtime alongside in {runtime_build['s']:.1f} s)", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "ptxas.txt"), "w") as f:
        f.write("\n".join(f"[{k}]\n{v}" for k, v in reports.items()))
    gemm_sass_check()

    k1, k2 = kernel_phase(card)
    k4f, k4b, k5f_ksvqe, k5b_ksvqe = train_kernel_phase(card)
    b1 = train_kernel_phase(card, batch=1)  # the (data, fsdp) step's rows
    k5f, k5b = swin_train_kernel_phase(card)
    for agg, other in ((k5f, k5f_ksvqe), (k5b, k5b_ksvqe)):
        agg["err"] = max(agg["err"], other["err"])
    gemm = gemm_phase(card)
    k3, k6, k7 = eval_attention_phase(card)
    k1_49, k4f_49, k4b_49 = swin2d_kernel_phase(card)
    run = main_path(card)
    ts2 = tuning_stage_2_path(card)
    swin = swin_path(card)
    train = train_path(card)
    swin_train = swin_train_path(card)
    cli_eval = cli_eval_path(card)
    cli_train_run = cli_train_path(card)
    svqa_eval = svqa_eval_path(card)
    svqa_train = svqa_train_path(card)
    svqa_files = svqa_files_path(card)
    files = svqa_files.pop("files")
    ddp_nccl = nccl_ddp_path(card)
    ddp_svqa = svqa_ddp_path(card)
    ddp_cli = cli_ddp_path(card, files)
    ddp_torchrun = torchrun_path(card, files)
    shutil.rmtree(files["root"])
    sharded = fsdp_path(card)
    dover = dover_path(card)
    swin2d = swin2d_path(card)
    clip_full = clip_full_path(card)

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
    stl = swin_train["launches"]
    s2l = swin2d["train"]["launches"]

    def k5_record(name, replaces, agg, counter, calls):
        """K5 runs in both train cells: its times and bound are those of
        the swin_tiny_grpb train step's calls at the four padded stage
        geometries; its launches are both cells' main-path runs."""
        by_cell = {"KSVQE train": tl[counter],
                   "swin_tiny_grpb train": stl[counter],
                   "swin_2d_tiny train": s2l[counter]}
        rec = record(
            name, "kvq_tpu_torch/ops/csrc/train_attention.cu", replaces,
            agg, sum(by_cell.values()), agg["lib_ms"],
            f"ms and bound: {calls} of one swin_tiny_grpb train step (B=4, "
            f"16x72x72 tokens padded per stage; remat repeats the forward "
            f"calls in the backward); launches: {TRAIN_STEPS} KSVQE train "
            f"steps (2 + 2 a step, stage 3), {SWIN_TRAIN_STEPS} "
            f"swin_tiny_grpb train steps at remat on (24 + 12 a step) and "
            f"one swin_2d_tiny train step (where the gate declines K4)")
        rec["launches_by_cell"] = by_cell
        return rec

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
        k5_record("window_attention_train",
                  "kvq_tpu/ops/window_attention.py:1376", k5f,
                  "window_attention_train", "the 12 forward calls"),
        k5_record("window_attention_train_bwd",
                  "kvq_tpu/ops/window_attention.py:1416", k5b,
                  "window_attention_train_bwd", "the 12 backward calls"),
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
    for rec in kernels:  # data-parallel runs: (a)'s steps, (c)'s two ranks
        rec["launches_data_parallel"] = (ddp_nccl["launches"][rec["name"]]
                                         + ddp_cli["launches"][rec["name"]])
        # the (data, fsdp) phase, rank 0: its timed steps and eval forward
        rec["launches_fsdp_rank0"] = sharded["launches_rank0"][rec["name"]]

    def at_shapes(agg, per):
        """A kernel's times and error at other shapes than its record's."""
        tb, tf = agg["bound"]
        return {"ms": agg["ms"], "plain_ms": agg["plain_ms"],
                "bound_ms": max(tb, tf),
                "bound_by": "bytes" if tb >= tf else "operations",
                "max_abs_err": agg["err"], "per": per}

    n49 = {"fused_swin_block": at_shapes(
        k1_49, "the calls of one swin_2d_tiny forward (B=1, T=8, 224 px)"),
        "train_swin_block": at_shapes(
        k4f_49, "the calls of one swin_2d_tiny train step (B=4, T=8, "
                "224 px)"),
        "train_swin_block_bwd": at_shapes(
        k4b_49, "the calls of one swin_2d_tiny train step (B=4, T=8, "
                "224 px)")}
    per_b1 = "the calls of a rank's (data, fsdp) step (B=1, T=32)"
    b1_recs = dict(zip(("train_swin_block", "train_swin_block_bwd",
                        "window_attention_train",
                        "window_attention_train_bwd"),
                       (at_shapes(a, per_b1) for a in b1)))
    paths = {"fused_swin_block": {
        "KSVQE eval": run["launches"]["fused_swin_block"],
        "swin_tiny,conv_tiny eval": dover["launches"]["fused_swin_block"],
        "swin_2d_tiny eval": swin2d["eval"]["launches"]["fused_swin_block"]},
        "train_swin_block": {"KSVQE train": tl["train_swin_block"],
                             "swin_2d_tiny train": s2l["train_swin_block"]},
        "train_swin_block_bwd": {
            "KSVQE train": tl["train_swin_block_bwd"],
            "swin_2d_tiny train": s2l["train_swin_block_bwd"]}}
    for rec in kernels:
        if rec["name"] in n49:
            rec["at_n49"] = n49[rec["name"]]
            rec["launches_by_path"] = paths[rec["name"]]
        if rec["name"] in b1_recs:
            rec["at_b1"] = b1_recs[rec["name"]]
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "k1_rows": k1["rows"], "k2_rows": k2["rows"],
                   "k4_fwd_rows": k4f["rows"], "k4_bwd_rows": k4b["rows"],
                   "k5_fwd_rows": k5f_ksvqe["rows"] + k5f["rows"],
                   "k5_bwd_rows": k5b_ksvqe["rows"] + k5b["rows"],
                   "k5_ksvqe_step": {k: k5f_ksvqe[k] for k in (
                       "ms", "plain_ms", "lib_ms", "bound")},
                   "k5_bwd_ksvqe_step": {k: k5b_ksvqe[k] for k in (
                       "ms", "plain_ms", "lib_ms", "bound")},
                   "k3_rows": k3["rows"], "k6_rows": k6["rows"],
                   "k7_rows": k7["rows"], "gemm": gemm, "run": run,
                   "tuning_stage_2": ts2,
                   "swin": swin, "train": train, "swin_train": swin_train,
                   "cli_eval": cli_eval, "cli_train": cli_train_run,
                   "simplevqa_eval": svqa_eval,
                   "simplevqa_train": svqa_train,
                   "simplevqa_files": svqa_files,
                   "ddp_nccl": ddp_nccl, "ddp_simplevqa": ddp_svqa,
                   "ddp_cli_test": ddp_cli, "ddp_torchrun": ddp_torchrun,
                   "fsdp": sharded,
                   "k1_n49_rows": k1_49["rows"],
                   "k4_fwd_n49_rows": k4f_49["rows"],
                   "b1_rows": {k: a["rows"] for k, a in zip(
                       ("k4_fwd", "k4_bwd", "k5_fwd", "k5_bwd"), b1)},
                   "k4_bwd_n49_rows": k4b_49["rows"],
                   "two_branch": dover, "swin_2d_tiny": swin2d,
                   "clip_full": clip_full, "kernels": kernels}, f,
                  indent=1)
    print(card, flush=True)  # name, power limit: nvidia-smi's own line
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
