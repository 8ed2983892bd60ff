"""OpenCV's ``cv2.resize`` with ``INTER_AREA`` and ``INTER_LINEAR``, in
numpy (the JAX package calls cv2 at kvq_tpu/data/views.py:68-76 and
kvq_tpu/data/fragments.py:121-142); the port needs no OpenCV to make its
views.

Both work on one frame (H, W, C) or a video (T, H, W, C), uint8 or
float32, and compute each output pixel from the same taps, weights and
arithmetic order as the code cv2 runs (OpenCV 5.0, modules/imgproc/src/
resize.cpp, and for float32 bilinear Intel IPP, which cv2 calls there):

- **area** (``INTER_AREA`` when neither side grows): a separable weighted
  sum, along each row first, then down the columns.  Each output column
  (then row) reads the ceil(scale)+1 input columns (rows) it overlaps,
  with their fractional overlaps as float32 weights, accumulated in float32
  in input order; uint8 results round half to even, as OpenCV's saturate
  cast.  When both scales are integers OpenCV sums whole blocks instead:
  2x2 blocks as ``(sum + 2) >> 2``, others as ``sum * (1 / area)``; so does
  this.
- **linear** (``INTER_LINEAR``, and ``INTER_AREA`` when a side grows), on
  uint8 and in area mode: OpenCV's generic code, two taps per axis whose
  fraction is rounded to float32 before the floor is taken off it
  (:func:`linear_taps`); the horizontal taps are clamped at the edges, the
  vertical ones clip only their rows and keep their fraction.  uint8 runs
  in OpenCV's 11-bit fixed point, float32 as ``a * w0 + b * w1``.
- **linear on float32** frames with both sides of 2 or more: IPP's code
  (:func:`ipp_taps`, :func:`_linear_ipp`), each pass a fused multiply-add
  ``a + (b - a) * f``; its fraction is taken in float64 and then rounded.

Bit-equal to cv2 5.0 on every size the tests try, the float32 bilinear to
cv2 with IPP on as shipped, on an AVX-512 host (IPP picks its code by CPU).

The tap tables depend only on the two sizes and are cached.  The scale of
an axis is ``1 / (out / in)``, as OpenCV computes it: ``in / out`` can
round to the other side of an integer and move a tap (IPP takes
``in / out``).
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
def linear_taps(src: int, dst: int, area_mode: bool = False,
                vertical: bool = False):
    """``(i0, i1, w0, w1)``, each (dst,): the two input positions of each
    output position and their float32 weights, as OpenCV's generic resize
    computes them: the position in float64, rounded to float32, then
    ``s = floor``, ``f -= s``.  ``area_mode`` takes OpenCV's INTER_AREA
    coefficients for a growing side.  On the horizontal axis a tap outside
    the row is clamped with its fraction set to 0; on the ``vertical`` one
    only the rows are clipped, and both weights may read the same row."""
    scale = _scale(src, dst)
    inv = dst / src
    s = np.empty(dst, np.int64)
    w1 = np.empty(dst, np.float32)
    for d in range(dst):
        if area_mode:
            s[d] = math.floor(d * scale)
            f = float(np.float32((d + 1) - (s[d] + 1) * inv))
            w1[d] = 0.0 if f <= 0 else f - math.floor(f)
        else:
            f = float(np.float32((d + 0.5) * scale - 0.5))
            s[d] = math.floor(f)
            w1[d] = f - s[d]
    if not vertical:
        w1[(s < 0) | (s >= src - 1)] = 0
    return _frozen(np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1),
                   np.float32(1) - w1, w1)


@functools.lru_cache(maxsize=64)
def ipp_taps(src: int, dst: int):
    """``(i0, i1, f, n_left, n_right)``: IPP's bilinear taps for float32,
    the position ``(d + 0.5) * (src / dst) - 0.5`` in float64, its
    fraction rounded to float32, rows or columns clipped at the edges; and
    how many output positions lie on each edge (the position < 0 or at
    least ``src - 1``)."""
    pos = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    s = np.floor(pos)
    f = (pos - s).astype(np.float32)
    s = s.astype(np.int64)
    return _frozen(np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1),
                   f) + (int((s < 0).sum()), int((s >= src - 1).sum()))


def _fma(x, y, z) -> np.ndarray:
    """``x * y + z`` on float32 arrays (``z`` of the result's shape),
    rounded to float32 once.  The float64 product is exact; the float64
    sum rounds a second time, which matters only where it lands on a
    float32 tie: there the sum's own error (Knuth's two-sum) says which way
    the exact value lies."""
    p = x.astype(np.float64)
    p *= np.asarray(y, np.float64)
    s = p + z
    flat = s.reshape(-1)
    at = np.flatnonzero((flat.view(np.int64) & 0x1FFFFFFF) == 0x10000000)
    if at.size:
        p, z, t = p.reshape(-1)[at], np.reshape(z, -1)[at], flat[at]
        back = t - p
        err = (p - (t - back)) + (z - back)
        flat[at] = np.nextafter(t, np.copysign(np.inf, err), where=err != 0,
                                out=t)
    return s.astype(np.float32)


def _edge_columns(out_w: int, n_left: int, n_right: int) -> np.ndarray:
    """The output columns whose vertical pass IPP does without fusing the
    multiply-add on channels 0 and 1 of 3: on each edge, the columns past
    its whole groups of 16 when at least 5 are left over (measured with
    cv2 5.0 on AVX-512)."""
    left = n_left % 16 if n_left % 16 >= 5 else 0
    right = n_right % 16 if n_right % 16 >= 5 else 0
    return np.r_[n_left - left:n_left, out_w - right:out_w].astype(np.int64)


def _linear_ipp(video: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """float32 bilinear as IPP computes it: along the rows, then down the
    columns, each ``fma(b - a, f, a)``."""
    y0, y1, fy, _, _ = ipp_taps(video.shape[1], out_h)
    x0, x1, fx, n_left, n_right = ipp_taps(video.shape[2], out_w)
    edge = (_edge_columns(out_w, n_left, n_right) if video.shape[3] == 3
            else np.empty(0, np.int64))
    fx, fy = fx[:, None], fy[:, None, None]

    def chunk(v):
        a = np.take(v, x0, axis=2)
        rows = _fma(np.take(v, x1, axis=2) - a, fx, a)
        r0 = np.take(rows, y0, axis=1)
        step = np.take(rows, y1, axis=1) - r0
        out = _fma(step, fy, r0)
        if edge.size:
            out[:, :, edge, :2] = (r0[:, :, edge, :2]
                                   + step[:, :, edge, :2] * fy)
        return out

    return _chunks(video, chunk)


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
    h, w = video.shape[1:3]
    if video.dtype == np.float32 and not area_mode and min(h, w) > 1:
        return _linear_ipp(video, out_h, out_w)
    y0, y1, b0, b1 = linear_taps(h, out_h, area_mode, vertical=True)
    x0, x1, a0, a1 = linear_taps(w, out_w, area_mode)
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
