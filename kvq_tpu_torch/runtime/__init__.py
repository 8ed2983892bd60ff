"""The port's native host runtime (runtime/kvq_runtime.cpp) through ctypes
(counterpart of kvq_tpu/runtime/__init__.py:140-182): the KVQ sample's
fragment mosaic and resize view, each fused with its normalisation, over
the frames of a clip on ``n_threads`` threads (4, as the JAX package's).

The library is built at first use with
``g++ -O3 -fPIC -shared -std=c++17 -pthread -ffp-contract=off`` (``$CXX``
when set): no ``-ffast-math``, and no contraction of ``w * v + acc`` into
fused multiply-adds, so that the resize stays bit-equal to
data/resize.py.  It needs no OpenCV.  It is cached under ``runtime/_build/``
by a hash of the source and the flags; nothing is built at import.  A
failed build raises with the compiler's output: no caller falls back to
numpy on its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "kvq_runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread",
         "-ffp-contract=off")
N_THREADS = 4

_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = {
    "kvq_fragment_mosaic": (_P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P,
                            _P, _I),
    "kvq_resize": (_P, _I, _I, _I, _I, _I, _P, _I),
    "kvq_resize_normalize": (_P, _I, _I, _I, _I, _I, _P, _P, _I, _P, _I),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("the native runtime needs a C++ compiler: no g++ "
                           "on PATH and no $CXX")
    return cxx


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libkvq_runtime-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it is cached; returns its path.  The
    compiler writes a name of its own process and the result is renamed
    into place, so concurrent builds never load half a file."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [compiler(), *FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        log = res.stdout + res.stderr
    except OSError as e:  # no such compiler
        res, log = None, str(e)
    if res is None or res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native runtime failed: "
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The library, built on first use, with its argtypes declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = None
            _lib = lib
        return _lib


def _video(video: np.ndarray) -> np.ndarray:
    video = np.ascontiguousarray(video)
    if video.dtype != np.uint8 or video.ndim != 4 or video.shape[3] != 3:
        raise ValueError(f"expected a (T, H, W, 3) uint8 video, got "
                         f"{video.dtype} {video.shape}")
    return video


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def fragment_mosaic_normalize(video, ymap, xmap, aligned: int, mean, std,
                              n_threads: int = N_THREADS) -> np.ndarray:
    """``out[t, oy, ox] = (video[t, ymap[g, oy, ox], xmap[g, oy, ox]] - mean)
    * (1 / std)`` with ``g = t // aligned`` (clamped to the last group):
    (T, H, W, 3) uint8 -> (T, oh, ow, 3) float32."""
    video = _video(video)
    T, H, W, _ = video.shape
    ymap = np.ascontiguousarray(ymap, dtype=np.int32)
    xmap = np.ascontiguousarray(xmap, dtype=np.int32)
    if ymap.shape != xmap.shape or ymap.ndim != 3:
        raise ValueError(f"index maps {ymap.shape} and {xmap.shape}")
    if ymap.size and not (0 <= ymap.min() and ymap.max() < H
                          and 0 <= xmap.min() and xmap.max() < W):
        raise ValueError(f"index maps reach outside the {H}x{W} frame")
    tg, oh, ow = ymap.shape
    mean, std = _f32(mean), _f32(std)
    out = np.empty((T, oh, ow, 3), np.float32)
    load().kvq_fragment_mosaic(
        video.ctypes.data, T, H, W, ymap.ctypes.data, xmap.ctypes.data, tg,
        int(aligned), oh, ow, mean.ctypes.data, std.ctypes.data,
        out.ctypes.data, int(n_threads))
    return out


def resize(video, oh: int, ow: int, n_threads: int = N_THREADS) -> np.ndarray:
    """Each frame resized as data/views.py resizes it (area when a side
    shrinks, else bilinear), uint8 -> uint8."""
    video = _video(video)
    T, H, W, _ = video.shape
    out = np.empty((T, oh, ow, 3), np.uint8)
    load().kvq_resize(video.ctypes.data, T, H, W, int(oh), int(ow),
                      out.ctypes.data, int(n_threads))
    return out


def resize_normalize(video, oh: int, ow: int, mean, std, div255: bool,
                     n_threads: int = N_THREADS) -> np.ndarray:
    """:func:`resize`, then ``(v * scale - mean) * (1 / std)`` with scale
    1/255 when ``div255`` (the CLIP profile): float32 out."""
    video = _video(video)
    T, H, W, _ = video.shape
    mean, std = _f32(mean), _f32(std)
    out = np.empty((T, oh, ow, 3), np.float32)
    load().kvq_resize_normalize(
        video.ctypes.data, T, H, W, int(oh), int(ow), mean.ctypes.data,
        std.ctypes.data, 1 if div255 else 0, out.ctypes.data, int(n_threads))
    return out
