"""Offline SlowFast motion features (counterpart of
kvq_tpu/cli/slowfast_features.py; reference SlowFast_features.py):

    python -m kvq_tpu_torch.cli.slowfast_features --videos_csv list.csv \
        --video_root /data/videos --out /data/feat [--resize 224] \
        [--load_path slowfast_r50.pth] [--device cpu]

Per video of the CSV (a header, the name in the first column): decode
every frame with cv2 and resize it to ``resize`` x ``resize`` (INTER_LINEAR)
as it is read, normalise with the ``slowfast`` profile ((x/255 - 0.45) /
0.225), cut per-second 32-frame clips (the last frame repeated past the
end, at least 8 clips, 10 when the file reports 0 fps), run SlowFast-R50
on the card (``--device cpu`` only when asked) over the video's clips in
batches (eval BatchNorm: each clip's features do not depend on the
others), and write ``<out>/<name>/feature_<k>_slow_feature.npy`` (2048)
and ``feature_<k>_fast_feature.npy`` (256), the files SimpleVQADataset
reads.  ``--load_path``: a pytorchvideo ``slowfast_r50`` state dict
(``.pth``), or a JAX msgpack file of ``SlowFastR50`` params and
batch_stats; without it the weights are seeded.
"""

from __future__ import annotations

import argparse
import csv
import os
import time

import numpy as np
import torch

from ..core.checkpoint import (
    is_msgpack,
    load_checkpoint,
    merge_state_dict,
    weights_of,
)
from ..core.device import resolve_device
from ..core.from_jax import map_slowfast_tree
from ..data import views as V
from ..models.vqa_network import init_weights
from ..nn.slowfast import SlowFastR50, pack_pathways

CLIP_LEN = 32
MIN_CLIPS = 8
CLIP_BATCH = 16  # clips of one video run together


def _resize(frame: np.ndarray, resize: int) -> np.ndarray:
    import cv2

    return cv2.resize(frame, (resize, resize), interpolation=cv2.INTER_LINEAR)


def clips_of(resized: np.ndarray, fps: int) -> list[np.ndarray]:
    """(T, r, r, 3) resized frames -> the normalised (32, r, r, 3) float32
    clips (SlowFast_features.py:64-105)."""
    n = len(resized)
    n_clips = 10 if fps == 0 else int(n / fps)
    frames = V.normalize(resized, "slowfast")
    clips = []
    for i in range(n_clips):
        start = i * fps
        clip = np.zeros((CLIP_LEN,) + frames.shape[1:], np.float32)
        avail = frames[start:start + CLIP_LEN]
        clip[:len(avail)] = avail
        if 0 < len(avail) < CLIP_LEN:
            clip[len(avail):] = avail[-1]
        clips.append(clip)
    while len(clips) < MIN_CLIPS and clips:
        clips.append(clips[-1])
    return clips


def video_to_clips(frames: np.ndarray, fps: int, resize: int = 224):
    """(T, H, W, C) uint8 frames -> the list of (32, resize, resize, 3)
    float32 clips."""
    return clips_of(np.stack([_resize(f, resize) for f in frames]), fps)


def read_resized(path: str, resize: int = 224) -> tuple[np.ndarray, int]:
    """(every frame of the file, RGB, resized as it is read (uint8), the
    rounded fps)."""
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        fps = int(round(cap.get(cv2.CAP_PROP_FPS)))
        frames = []
        while True:
            ok, fr = cap.read()
            if not ok:
                break
            frames.append(_resize(cv2.cvtColor(fr, cv2.COLOR_BGR2RGB), resize))
    finally:
        cap.release()
    if not frames:
        return np.zeros((0, resize, resize, 3), np.uint8), fps
    return np.stack(frames), fps


@torch.no_grad()
def extract_features(model: SlowFastR50, clips, device) -> list:
    """[(slow (2048,), fast (256,)) float32 numpy] for each clip, up to
    ``CLIP_BATCH`` clips a batch."""
    feats = []
    for i in range(0, len(clips), CLIP_BATCH):
        batch = torch.from_numpy(np.stack(clips[i:i + CLIP_BATCH])).to(device)
        slow, fast = model(*pack_pathways(batch))
        feats += zip(slow.cpu().numpy(), fast.cpu().numpy())
    return feats


def write_features(out_dir: str, feats) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for k, (s, f) in enumerate(feats):
        np.save(os.path.join(out_dir, f"feature_{k}_slow_feature.npy"), s)
        np.save(os.path.join(out_dir, f"feature_{k}_fast_feature.npy"), f)


def load_model(load_path: str | None, device, seed: int = 0) -> SlowFastR50:
    """SlowFast-R50 on ``device`` in eval: seeded weights, then those of
    ``load_path`` merged (its report printed)."""
    with torch.device(device):
        model = SlowFastR50()
    init_weights(model, seed)
    if load_path:
        loaded = load_checkpoint(load_path)
        if is_msgpack(load_path):
            sd, unread = map_slowfast_tree(loaded.get("params", loaded),
                                           loaded.get("batch_stats"))
            report = merge_state_dict(model, sd, reference=False)
            report["unexpected"] += unread
        else:
            report = merge_state_dict(model, weights_of(loaded))
        print("loaded", load_path, {k: len(v) for k, v in report.items()})
    return model.eval()


def run(names, video_root: str, out: str, model: SlowFastR50,
        resize: int = 224) -> dict:
    """Features of each named video under ``out``; returns the counts and
    the seconds of decode (and resize), clip assembly and SlowFast (the
    copy to the device and the features' read-back included)."""
    device = next(model.parameters()).device
    stats = {"videos": 0, "clips": 0, "decode_s": 0.0, "clips_s": 0.0,
             "model_s": 0.0}
    for name in names:
        t0 = time.perf_counter()
        resized, fps = read_resized(os.path.join(video_root, name), resize)
        t1 = time.perf_counter()
        if not len(resized):
            print("skipping (no frames):", name)
            continue
        clips = clips_of(resized, fps)
        t2 = time.perf_counter()
        feats = extract_features(model, clips, device) if clips else []
        t3 = time.perf_counter()
        write_features(os.path.join(out, name), feats)
        stats["videos"] += 1
        stats["clips"] += len(clips)
        stats["decode_s"] += t1 - t0
        stats["clips_s"] += t2 - t1
        stats["model_s"] += t3 - t2
        print("done:", name, len(clips), "clips")
    return stats


def parse_args(argv=None):
    p = argparse.ArgumentParser("kvq_tpu_torch slowfast_features")
    p.add_argument("--videos_csv", required=True,
                   help="csv with a header, the video name in column 0")
    p.add_argument("--video_root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--resize", type=int, default=224)
    p.add_argument("--load_path", default=None,
                   help="pytorchvideo slowfast_r50 .pth or a JAX msgpack")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    with open(args.videos_csv, newline="") as f:
        rows = csv.reader(f)
        next(rows)
        names = [row[0] for row in rows]
    model = load_model(args.load_path, device)
    return run(names, args.video_root, args.out, model, args.resize)


if __name__ == "__main__":
    main()
