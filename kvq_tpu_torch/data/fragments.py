"""Spatial fragment mosaic (DOVER/FAST-VQA "fragments") and its
space-to-depth packing (copy of kvq_tpu/data/fragments.py).

Semantics of the reference ``get_spatial_fragments``
(fusion_datasets.py:22-121):
  - grid origins ``min(res//frag * i, res - fsize)``;
  - per-(cell, time-group) jitter ``randint(0, grid_len - fsize)`` when the
    grid cell is larger than the fragment, else 0;
  - time groups of ``aligned`` frames share one jitter draw;
  - bilinear upsample when the video is smaller than the mosaic
    (``fallback_type='upsample'``, ratio < 1), through
    :func:`~kvq_tpu_torch.data.resize.resize` on float32 frames (the JAX
    package calls cv2's INTER_LINEAR there).
The mosaic is one block copy per (time group, cell).
"""

from __future__ import annotations

import numpy as np

from .resize import resize

def _grid_origins(res: int, frags: int, fsize: int) -> np.ndarray:
    return np.array(
        [min(res // frags * i, res - fsize) for i in range(frags)], dtype=np.int64
    )


def fragment_index_maps(
    res_h: int,
    res_w: int,
    dur_t: int,
    fragments_h: int = 7,
    fragments_w: int = 7,
    fsize_h: int = 32,
    fsize_w: int = 32,
    aligned: int = 32,
    rng: np.random.Generator | None = None,
    rnd_h: np.ndarray | None = None,
    rnd_w: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Build gather maps ``ymap, xmap`` of shape (Tg, Fh*fh, Fw*fw).

    ``out[t, oy, ox] = video[t, ymap[t // aligned, oy, ox],
    xmap[t // aligned, oy, ox]]`` reproduces the reference mosaic.
    Jitters may be passed explicitly (``rnd_h/rnd_w`` of shape (Fh, Fw, Tg))
    for golden tests against the reference semantics.
    """
    tgroups = dur_t // aligned
    hgrids = _grid_origins(res_h, fragments_h, fsize_h)
    wgrids = _grid_origins(res_w, fragments_w, fsize_w)
    hlength, wlength = res_h // fragments_h, res_w // fragments_w

    if rng is None:
        rng = np.random.default_rng(0)
    if rnd_h is None:
        if hlength > fsize_h:
            rnd_h = rng.integers(
                0, hlength - fsize_h, size=(fragments_h, fragments_w, tgroups)
            )
        else:
            rnd_h = np.zeros((fragments_h, fragments_w, tgroups), dtype=np.int64)
    if rnd_w is None:
        if wlength > fsize_w:
            rnd_w = rng.integers(
                0, wlength - fsize_w, size=(fragments_h, fragments_w, tgroups)
            )
        else:
            rnd_w = np.zeros((fragments_h, fragments_w, tgroups), dtype=np.int64)

    # Source start per (cell_i, cell_j, tgroup).
    ys = hgrids[:, None, None] + rnd_h  # (Fh, Fw, Tg)
    xs = wgrids[None, :, None] + rnd_w  # (Fh, Fw, Tg)

    dy = np.arange(fsize_h)
    dx = np.arange(fsize_w)
    # ymap[tg, i*fh + dy, j*fw + dx] = ys[i, j, tg] + dy
    ymap = (ys[:, :, :, None, None] + dy[None, None, None, :, None]).astype(np.int64)
    xmap = (xs[:, :, :, None, None] + dx[None, None, None, None, :]).astype(np.int64)
    # -> (Tg, Fh, fh, Fw, fw)
    ymap = np.broadcast_to(
        ymap.transpose(2, 0, 3, 1, 4),
        (tgroups, fragments_h, fsize_h, fragments_w, fsize_w),
    ).reshape(tgroups, fragments_h * fsize_h, fragments_w * fsize_w)
    xmap = np.broadcast_to(
        xmap.transpose(2, 0, 3, 1, 4),
        (tgroups, fragments_h, fsize_h, fragments_w, fsize_w),
    ).reshape(tgroups, fragments_h * fsize_h, fragments_w * fsize_w)
    return ymap, xmap


def get_spatial_fragments(
    video: np.ndarray,
    fragments_h: int = 7,
    fragments_w: int = 7,
    fsize_h: int = 32,
    fsize_w: int = 32,
    aligned: int = 32,
    fallback_type: str = "upsample",
    rng: np.random.Generator | None = None,
    rnd_h: np.ndarray | None = None,
    rnd_w: np.ndarray | None = None,
    **_: object,
) -> np.ndarray:
    """Fragment mosaic over a (T, H, W, C) uint8/float video (channels-last).

    Returns (T, Fh*fh, Fw*fw, C).  Single-frame inputs use aligned=1
    (reference fusion_datasets.py:39-40).
    """
    if video.shape[0] == 1:
        aligned = 1
    dur_t, res_h, res_w = video.shape[0], video.shape[1], video.shape[2]
    size_h, size_w = fragments_h * fsize_h, fragments_w * fsize_w

    ratio = min(res_h / size_h, res_w / size_w)
    if fallback_type == "upsample" and ratio < 1:
        # Bilinear upscale by 1/ratio, like reference F.interpolate
        # (fusion_datasets.py:44-50), on float32 frames; uint8 videos are
        # truncated back to uint8 as the JAX package does.
        new_h, new_w = int(res_h / ratio), int(res_w / ratio)
        up = resize(np.asarray(video, dtype=np.float32), new_h, new_w,
                    "linear")
        video = up.astype(video.dtype) if video.dtype == np.uint8 else up
        res_h, res_w = new_h, new_w

    if dur_t % aligned != 0:
        raise ValueError(
            f"clip length {dur_t} must be a multiple of aligned={aligned}"
        )

    ymap, xmap = fragment_index_maps(
        res_h,
        res_w,
        dur_t,
        fragments_h,
        fragments_w,
        fsize_h,
        fsize_w,
        aligned,
        rng=rng,
        rnd_h=rnd_h,
        rnd_w=rnd_w,
    )
    # Blocked slice copy: each (tgroup, cell) shares one jitter, so the
    # mosaic is Tg*Fh*Fw block copies, equal to the per-pixel gather that
    # the index maps describe.
    tgroups = dur_t // aligned
    out = np.empty((dur_t, size_h, size_w) + video.shape[3:], video.dtype)
    for g in range(tgroups):
        t0, t1 = g * aligned, (g + 1) * aligned
        for i in range(fragments_h):
            oy = i * fsize_h
            for j in range(fragments_w):
                ox = j * fsize_w
                ys = int(ymap[g, oy, ox])
                xs = int(xmap[g, oy, ox])
                out[t0:t1, oy:oy + fsize_h, ox:ox + fsize_w] = video[
                    t0:t1, ys:ys + fsize_h, xs:xs + fsize_w
                ]
    return out


def get_spatial_cropped_fragments(
    video: np.ndarray,
    fragments_h: int = 7,
    fragments_w: int = 7,
    fsize_h: int = 32,
    fsize_w: int = 32,
    aligned: int = 32,
    fallback_type: str = "upsample",
    rng: np.random.Generator | None = None,
    **_: object,
) -> np.ndarray:
    """Center-cropped fragment variant (reference
    get_spatial_cropped_fragments, fusion_datasets.py:123-226): crop the
    height to a centered band of 2/3 the *width*, then build the standard
    mosaic over the crop.  (T, H, W, C) channels-last in/out."""
    res_h, res_w = video.shape[1], video.shape[2]
    center_h = res_h // 2
    crop_h = res_w // 3 * 2
    top = max(center_h - crop_h // 2, 0)
    cropped = video[:, top : top + crop_h]
    return get_spatial_fragments(
        cropped,
        fragments_h=fragments_h,
        fragments_w=fragments_w,
        fsize_h=fsize_h,
        fsize_w=fsize_w,
        aligned=aligned,
        fallback_type=fallback_type,
        rng=rng,
    )


def s2d_pack(video: np.ndarray, patch: tuple[int, int, int] = (2, 4, 4)) -> np.ndarray:
    """(T, H, W, C) -> (T/pt, H/ph, W/pw, pt*ph*pw*C), each patch's elements
    in (ti, hi, wi, c) order: the flatten order of the PatchEmbed3D kernel,
    so the device-side embed is one plain matmul."""
    pt, ph, pw = patch
    T, H, W, C = video.shape
    if T % pt or H % ph or W % pw:
        raise ValueError(f"shape {(T, H, W)} is not divisible by {patch}")
    return np.ascontiguousarray(
        video.reshape(T // pt, pt, H // ph, ph, W // pw, pw, C)
        .transpose(0, 2, 4, 1, 3, 5, 6)
        .reshape(T // pt, H // ph, W // pw, pt * ph * pw * C)
    )


def s2d_unpack(packed: np.ndarray, patch: tuple[int, int, int] = (2, 4, 4)) -> np.ndarray:
    """Inverse of :func:`s2d_pack` (exact)."""
    pt, ph, pw = patch
    T2, Hp, Wp, K = packed.shape
    C = K // (pt * ph * pw)
    return np.ascontiguousarray(
        packed.reshape(T2, Hp, Wp, pt, ph, pw, C)
        .transpose(0, 3, 1, 4, 2, 5, 6)
        .reshape(T2 * pt, Hp * ph, Wp * pw, C)
    )
