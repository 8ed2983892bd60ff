"""Space-to-depth packing of the fragment mosaic (copy of
kvq_tpu/data/fragments.py:s2d_pack/s2d_unpack)."""

from __future__ import annotations

import numpy as np


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
