"""OpenCV's ``cv2.resize`` with ``INTER_AREA`` and ``INTER_LINEAR``, in
numpy (the JAX package calls cv2 at kvq_tpu/data/views.py:68-76 and
kvq_tpu/data/fragments.py:121-142); the port needs no OpenCV to make its
views.

Both work on one frame (H, W, C) or a video (T, H, W, C), uint8 or
float32, and compute each output pixel from the same taps, weights and
arithmetic order as OpenCV's generic code (modules/imgproc/src/resize.cpp):

- **area** (``INTER_AREA`` when neither side grows): a separable weighted
  sum, along each row first, then down the columns.  Each output column
  (then row) reads the ceil(scale)+1 input columns (rows) it overlaps,
  with their fractional overlaps as float32 weights, accumulated in float32
  in input order; uint8 results round half to even, as OpenCV's saturate
  cast.  When both scales are integers OpenCV sums whole blocks instead:
  2x2 blocks as ``(sum + 2) >> 2``, others as ``sum * (1 / area)``; so does
  this.  Equal to cv2 5.0 on every size the tests try.
- **linear** (``INTER_LINEAR``, and ``INTER_AREA`` when a side grows):
  two taps per axis at half-pixel centres, clamped at the edges; float32
  input is interpolated in float32 (within 5e-5 of cv2 on 0-255 values),
  uint8 input in OpenCV's 11-bit fixed point (cv2 5.0, through its IPP
  layer, differs by 1 on up to ~2 % of pixels).

The tap tables depend only on the two sizes and are cached.  The scale of
an axis is ``1 / (out / in)``, as OpenCV computes it: ``in / out`` can
round to the other side of an integer and move a tap.
"""

from __future__ import annotations

import functools
import math

import numpy as np

# frames resized together: one keeps the temporaries in the cache (the
# fastest of 1, 2 and 4 for 96 frames of 1280x720 on the host)
_FRAMES_PER_CHUNK = 1
_COEF_BITS = 11        # OpenCV's INTER_RESIZE_COEF_BITS
_DBL_EPSILON = 2.220446049250313e-16


def _scale(src: int, dst: int) -> float:
    return 1.0 / (dst / src)


def _frozen(*arrays):
    for a in arrays:
        a.setflags(write=False)
    return arrays


@functools.lru_cache(maxsize=64)
def area_taps(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """``(index, weight)``, each (dst, K): the input positions each output
    position averages and their float32 weights, in OpenCV's order
    (``computeResizeAreaTab``); unused taps repeat the last index with
    weight 0."""
    scale = _scale(src, dst)
    rows = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(math.floor(f2), src - 1)
        s1 = min(math.ceil(f1), s2)
        taps = []
        if s1 - f1 > 1e-3:
            taps.append((s1 - 1, (s1 - f1) / cell))
        taps += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            taps.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        rows.append(taps)
    k = max(len(t) for t in rows)
    index = np.empty((dst, k), np.int64)
    weight = np.zeros((dst, k), np.float32)
    for d, taps in enumerate(rows):
        index[d] = taps[-1][0]
        for j, (s, w) in enumerate(taps):
            index[d, j] = s
            weight[d, j] = w
    return _frozen(index, weight)


@functools.lru_cache(maxsize=64)
def linear_taps(src: int, dst: int, area_mode: bool = False):
    """``(i0, i1, w0, w1)``, each (dst,): the two input positions of each
    output position and their float32 weights.  ``area_mode`` takes
    OpenCV's INTER_AREA coefficients for a growing side."""
    scale = _scale(src, dst)
    inv = dst / src
    i0 = np.empty(dst, np.int64)
    w1 = np.empty(dst, np.float64)
    for d in range(dst):
        if area_mode:
            s = math.floor(d * scale)
            f = (d + 1) - (s + 1) * inv
            f = 0.0 if f <= 0 else f - math.floor(f)
        else:
            f = (d + 0.5) * scale - 0.5
            s = math.floor(f)
            f -= s
        if s < 0:
            s, f = 0, 0.0
        if s >= src - 1:
            s, f = src - 1, 0.0
        i0[d], w1[d] = s, f
    i1 = np.minimum(i0 + 1, src - 1)
    return _frozen(i0, i1, (1.0 - w1).astype(np.float32),
                   w1.astype(np.float32))


def _chunks(video: np.ndarray, fn) -> np.ndarray:
    """``fn`` over the frames of a (T, H, W, C) video a few at a time."""
    return np.concatenate([fn(video[t:t + _FRAMES_PER_CHUNK])
                           for t in range(0, len(video), _FRAMES_PER_CHUNK)])


def _to_dtype(out: np.ndarray, dtype) -> np.ndarray:
    if dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out


def _area_generic(video: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    t, h, w, c = video.shape
    iy, wy = area_taps(h, out_h)
    ix, wx = area_taps(w, out_w)
    # the rows pass on each frame as (H, W*C): every tap gathers single
    # elements of contiguous rows and scales them by a contiguous weight row
    cols = [(ix[:, k, None] * c + np.arange(c)).ravel()
            for k in range(ix.shape[1])]
    weights = [np.repeat(wx[:, k], c) for k in range(ix.shape[1])]

    def chunk(v):
        x = v.reshape(-1, w * c)
        rows = np.take(x, cols[0], axis=1) * weights[0]
        product = np.empty_like(rows)
        for col, wt in zip(cols[1:], weights[1:]):
            rows += np.multiply(np.take(x, col, axis=1), wt, out=product)
        rows = rows.reshape(len(v), h, out_w * c)
        out = np.take(rows, iy[:, 0], axis=1) * wy[:, 0, None]
        for k in range(1, iy.shape[1]):
            out += np.take(rows, iy[:, k], axis=1) * wy[:, k, None]
        return _to_dtype(out.reshape(len(v), out_h, out_w, c), video.dtype)

    return _chunks(video, chunk)


def _area_blocks(video: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    t, h, w = video.shape[:3]
    sy, sx = h // out_h, w // out_w
    blocks = video.reshape(t, out_h, sy, out_w, sx, *video.shape[3:])
    if video.dtype == np.uint8:
        total = blocks.sum(axis=(2, 4), dtype=np.int32)
        if sy == 2 and sx == 2:
            return ((total + 2) >> 2).astype(np.uint8)
        return _to_dtype(total.astype(np.float32)
                         * np.float32(1.0 / (sy * sx)), np.uint8)
    total = np.zeros((t, out_h, out_w) + video.shape[3:], np.float32)
    for i in range(sy):
        for j in range(sx):
            total += blocks[:, :, i, :, j]
    return total * np.float32(1.0 / (sy * sx))


def _linear(video: np.ndarray, out_h: int, out_w: int,
            area_mode: bool) -> np.ndarray:
    y0, y1, b0, b1 = linear_taps(video.shape[1], out_h, area_mode)
    x0, x1, a0, a1 = linear_taps(video.shape[2], out_w, area_mode)
    if video.dtype == np.uint8:
        one = float(1 << _COEF_BITS)
        a0, a1, b0, b1 = (np.rint(c * np.float32(one)).astype(np.int32)
                          for c in (a0, a1, b0, b1))

        def chunk(v):
            v = v.astype(np.int32)
            rows = (np.take(v, x0, axis=2) * a0[:, None]
                    + np.take(v, x1, axis=2) * a1[:, None])
            r0 = np.take(rows, y0, axis=1) >> 4
            r1 = np.take(rows, y1, axis=1) >> 4
            out = (((b0[:, None, None] * r0) >> 16)
                   + ((b1[:, None, None] * r1) >> 16) + 2) >> 2
            return np.clip(out, 0, 255).astype(np.uint8)
    else:
        def chunk(v):
            rows = (np.take(v, x0, axis=2) * a0[:, None]
                    + np.take(v, x1, axis=2) * a1[:, None])
            return (np.take(rows, y0, axis=1) * b0[:, None, None]
                    + np.take(rows, y1, axis=1) * b1[:, None, None])

    return _chunks(video, chunk)


def resize(video: np.ndarray, size_h: int, size_w: int,
           interpolation: str = "area") -> np.ndarray:
    """``cv2.resize(frame, (size_w, size_h), interpolation=...)`` on each
    frame of ``video`` ((H, W, C) or (T, H, W, C), uint8 or float32);
    ``interpolation`` is ``"area"`` or ``"linear"``."""
    if interpolation not in ("area", "linear"):
        raise ValueError(f"unknown interpolation {interpolation!r}")
    video = np.asarray(video)
    if video.dtype not in (np.uint8, np.float32):
        raise TypeError(f"resize takes uint8 or float32, got {video.dtype}")
    if video.ndim == 3:
        return resize(video[None], size_h, size_w, interpolation)[0]
    h, w = video.shape[1], video.shape[2]
    if (h, w) == (size_h, size_w):
        return video.copy()
    sy, sx = _scale(h, size_h), _scale(w, size_w)
    if interpolation == "area" and sy >= 1 and sx >= 1:
        if (abs(sy - round(sy)) < _DBL_EPSILON
                and abs(sx - round(sx)) < _DBL_EPSILON):
            return _area_blocks(video, size_h, size_w)
        return _area_generic(video, size_h, size_w)
    return _linear(video, size_h, size_w, area_mode=interpolation == "area")
