"""Builds the port's CUDA sources (``ops/csrc/*.cu``) at first use.

Each source becomes one shared library with a plain C interface, compiled by
``nvcc`` for ``sm_90a`` and loaded with ``ctypes``; all sources compile in
parallel, one ``nvcc`` process each.  Libraries are cached under
``ops/_build/`` by a hash of the sources, so an edited source rebuilds.
Nothing here runs at import: the CPU tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# name -> (exported function, argtypes)
LIBRARIES = {
    "gemm": {
        "kvq_gemm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _P, _I, _P),
        "kvq_gemm_bwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    },
    "swin_block": {
        "kvq_layernorm": (_P, _P, _P, _P, _I, _I, _F, _P),
        "kvq_layernorm_bwd": (
            _P, _P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _P, _I, _I, _F, _P,
        ),
        "kvq_colsum": (_P, _I, _P, _I, _P, _I, _I, _P),
        "kvq_scale_rows": (_P, _P, _I, _P, _I, _I, _P),
        "kvq_window_attention": (
            _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _F, _P, _P,
        ),
    },
    "nobias_attention": {
        "kvq_attention_nobias": (
            _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _F, _P,
        ),
    },
    "eval_attention": {
        "kvq_window_attention_heads": (
            *(_P,) * 6, _I, _I, _I, _I, _P, _P, _P, _P, _P, _F, _P,
        ),
        "kvq_attention_nobias_heads": (
            _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _F, _P,
        ),
    },
    "train_attention": {
        "kvq_window_attention_train": (
            _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _F,
            _P,
        ),
        "kvq_window_attention_bwd": (
            *(_P,) * 14, _I, _I, _I, _I, _I, _P, _P, _P, _P, _F, _P,
        ),
    },
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:12]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build_all() -> dict[str, str]:
    """Compile every missing library, all sources at once.  Returns the
    compiler's per-kernel resource report (``-Xptxas -v``) of each library
    it compiled."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in LIBRARIES:
        out = _lib_path(name)
        if out.exists():
            continue
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC),
               "-o", str(out) + ".tmp", str(CSRC / f"{name}.cu")]
        procs[name] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    reports, failed = {}, []
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(str(out) + ".tmp", out)
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The library ``name``, built on first use, with argtypes declared."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in LIBRARIES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _loaded[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
