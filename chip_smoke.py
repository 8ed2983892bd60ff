#!/usr/bin/env python3
"""Runs the port's main path — KSVQE eval scoring — on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit;
2. builds the CUDA kernels from ``kvq_tpu_torch/ops/csrc`` (nvcc, sm_90a);
3. holds K1 (fused_swin_block) against its plain version at each shipped
   stage geometry, unshifted and shifted, and K2 (flash_attention_nobias_cl)
   at the nine CDM shapes, on seeded bf16 inputs;
4. builds KSVQE + VQAHead at full width from seeded random weights in bf16,
   scores a few batches of the shipped eval shapes through the evaluator
   (``inference_test``), checks finite scores and 12 K1 + 9 K2 launches per
   forward, and compares the kernel path's score with the plain path's;
5. prints times, videos/s and a JSON line of kernel records, and as its last
   line ``{"ok": true, "device": {...}}``.

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


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# --------------------------------------------------------------------------
# kernel phases


def block_case(stage: int, shifted: bool, gen):
    import torch

    from kvq_tpu_torch.nn.swin import expand_bias_planes, get_window_size
    from kvq_tpu_torch.ops.window_attention import WindowGeometry

    dims, C, h, use_frag = STAGES[stage]
    win, shift = get_window_size(dims, (8, 7, 7),
                                 (4, 3, 3) if shifted else (0, 0, 0))
    geo = WindowGeometry(batch=1, dims=dims, window=win, shift=shift,
                         fragments=(1, 7, 7), num_heads=h, head_dim=C // h,
                         use_frag=use_frag)
    N, BW, hid = geo.n_tokens, geo.n_windows, 4 * C
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
    tl = 15 * 13 * 13
    rel = expand_bias_planes(rnd(tl, h, scale=0.5), (8, 7, 7), N)
    frag = (expand_bias_planes(rnd(tl, h, scale=0.5), (8, 7, 7), N)
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
    """K1 and K2 against their plain versions; returns timing records."""
    import torch
    import torch.nn.functional as F

    from kvq_tpu_torch.ops import window_attention as WA

    gen = torch.Generator(device="cuda").manual_seed(0)
    k1 = {"ms": 0.0, "plain_ms": 0.0, "bound": [0.0, 0.0], "err": 0.0,
          "rows": []}
    for stage in range(4):
        for shifted in (False, True):
            args, flops, nbytes = block_case(stage, shifted, gen)
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
            print(f"K1 stage{stage} shift={geo.shift} BW={geo.n_windows} "
                  f"C={args[0].shape[2]}: max|d|={err:.4g} "
                  f"(tol {K1_TOL * scale:.4g}) kernel {ms:.4f} ms, plain "
                  f"{pms:.4f} ms, bound {b:.4f} ms ({by}); {card}",
                  flush=True)
            if not ok:
                fail(f"K1 stage {stage} shift {geo.shift}: max|d| {err}")
            # a forward runs each stage's unshifted/shifted pair
            # depth/2 times: depths (2, 2, 6, 2)
            reps = (1, 1, 3, 1)[stage]
            k1["ms"] += reps * ms
            k1["plain_ms"] += reps * pms
            k1["bound"][0] += reps * nbytes / PEAK_BYTES * 1e3
            k1["bound"][1] += reps * flops / PEAK_BF16_FLOPS * 1e3
            k1["err"] = max(k1["err"], err)
            k1["rows"].append((stage, geo.shift, err, ms, pms, b, by))
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


def profile_forward(model, dev_batch) -> dict:
    """Device time by kernel family over one forward (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.no_grad():
            model(dev_batch, reduce_scores=True)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    top = []
    fam = {"kvq_window_attention": 0.0, "kvq_gemm": 0.0, "kvq_layernorm": 0.0,
           "kvq_nobias_attention": 0.0, "conv (cuDNN)": 0.0,
           "matmul (cuBLAS)": 0.0, "other": 0.0}
    syncs = {}  # host waits on the card inside the forward, by API call
    host = []   # host ops by self CPU time (profiled, so inflated)
    for evt in prof.key_averages():
        if "Synchronize" in evt.key:
            syncs[evt.key] = evt.count
        if getattr(evt, "device_type", None) is not None and \
                str(evt.device_type) != "DeviceType.CUDA":
            host.append((evt.self_cpu_time_total / 1e3, evt.count,
                         evt.key[:80]))
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if not us:
            continue
        name = evt.key
        top.append((us / 1e3, evt.count, name[:120]))
        if "flash_attention_kernel" in name and "true" in name.lower():
            k = "kvq_window_attention"
        elif "flash_attention_kernel" in name:
            k = "kvq_nobias_attention"
        elif "gemm_kernel" in name and "kvq" in name:
            k = "kvq_gemm"
        elif "layernorm_kernel" in name and "kvq" in name:
            k = "kvq_layernorm"
        elif "conv" in name.lower() or "cudnn" in name.lower() or \
                "implicit" in name.lower():
            k = "conv (cuDNN)"
        elif "gemm" in name.lower() or "cutlass" in name.lower() or \
                "sm90" in name.lower():
            k = "matmul (cuBLAS)"
        else:
            k = "other"
        fam[k] += us / 1e3
    busy = sum(fam.values())
    top.sort(reverse=True)
    host.sort(reverse=True)
    return {"wall_ms": wall, "device_ms": busy, "families_ms": fam,
            "syncs": syncs, "top_kernels": top[:15], "top_host_ops": host[:15]}


def main_path(card: str) -> dict:
    import torch

    from kvq_tpu_torch.data.pipeline import (
        host_tensors, pad_batch_rows, reshape_for_clips)
    from kvq_tpu_torch.models.vqa_network import build_model
    from kvq_tpu_torch.ops import window_attention as WA
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

    WA.fused_swin_block.launches = 0
    WA.flash_attention_nobias_cl.launches = 0
    t0 = time.perf_counter()
    results = ev.inference_test(batches, out_path)
    wall = time.perf_counter() - t0
    launches = {"fused_swin_block": WA.fused_swin_block.launches,
                "flash_attention_nobias_cl":
                    WA.flash_attention_nobias_cl.launches}
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
    if launches != {"fused_swin_block": 12 * N_BATCHES,
                    "flash_attention_nobias_cl": 9 * N_BATCHES}:
        fail(f"expected 12 K1 and 9 K2 launches per forward, got {launches}")
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
    profile_forward(model, dev_batch)  # profiler warm-up
    prof = profile_forward(model, dev_batch)
    # idle shares against unprofiled times: the profiler's own wall time
    # carries its tracing overhead
    video_ms = wall / len(results) * 1e3
    idle_fwd = 1.0 - prof["device_ms"] / fwd_ms
    idle_e2e = 1.0 - prof["device_ms"] / video_ms
    print(f"host prep of one batch (pad, pre-cast, pinned): {prep_ms:.2f} "
          f"ms; its host-to-device copy: {h2d_ms:.2f} ms; "
          f"forward on a device-resident batch: {fwd_ms:.2f} ms; the host's "
          f"dispatch of one forward (median of 3) {dispatch_ms:.2f} ms; "
          f"profiled forward: wall {prof['wall_ms']:.2f} ms, device busy "
          f"{prof['device_ms']:.2f} ms; idle share {idle_fwd:.3f} of the "
          f"forward, {idle_e2e:.3f} of {video_ms:.2f} ms per scored video; "
          f"by family {json.dumps(prof['families_ms'])}; host syncs "
          f"{json.dumps(prof['syncs'])}; {card}", flush=True)
    prof.update(prep_ms=prep_ms, h2d_ms=h2d_ms, forward_ms=fwd_ms,
                dispatch_ms=dispatch_ms,
                video_ms=video_ms,
                idle_share_forward=idle_fwd, idle_share_end_to_end=idle_e2e)
    return {"videos_per_s": len(results) / wall,
            "videos_per_s_again": len(results) / wall2, "launches": launches,
            "scores": scores, "plain_score": plain_score, "profile": prof}


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

    k1, k2 = kernel_phase(card)
    run = main_path(card)

    def record(name, source, replaces, agg, launches, lib):
        tb, tf = agg["bound"]
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": agg["err"], "ms": agg["ms"],
            "plain_ms": agg["plain_ms"], "bound_ms": max(tb, tf),
            "bound_by": "bytes" if tb >= tf else "operations",
            "library_ms": lib, "per": "the calls of one forward",
        }

    kernels = [
        record("fused_swin_block", "kvq_tpu_torch/ops/csrc/swin_block.cu",
               "kvq_tpu/ops/window_attention.py:975", k1,
               run["launches"]["fused_swin_block"], None),
        record("flash_attention_nobias_cl",
               "kvq_tpu_torch/ops/csrc/nobias_attention.cu",
               "kvq_tpu/ops/window_attention.py:560", k2,
               run["launches"]["flash_attention_nobias_cl"], k2["lib_ms"]),
    ]
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "k1_rows": k1["rows"], "k2_rows": k2["rows"],
                   "run": run, "kernels": kernels}, f, indent=1)
    print(card, flush=True)  # name, power limit: nvidia-smi's own line
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
