"""The native point locator: ``csrc/meshcore.cpp`` built with g++, bound by ctypes.

Counterpart of ``fluid_llm_tpu/core/_native.py``.  At first use the source
is compiled with the flags of ``native/Makefile`` into
``fluid_llm_tpu_torch/_build/``, keyed by a hash of the compiler, the flags
and the source (as ``ops/_build.py`` keys the CUDA kernels), then loaded.
``CXX`` in the environment names the compiler (default ``g++``).  A failed
build raises: nothing falls back to another locator here
(``core/triangulation.locate_triangles`` decides which one runs).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "meshcore.cpp"
BUILD_DIR = _PKG / "_build"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-Wextra")
LDFLAGS = ("-shared", "-lpthread")

_libs: dict[Path, ctypes.CDLL] = {}


def compiler() -> str:
    return os.environ.get("CXX") or "g++"


def library_path() -> Path:
    h = hashlib.sha256(" ".join((compiler(), *CXXFLAGS, *LDFLAGS)).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmeshcore-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``meshcore.cpp`` unless the library for this key exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler(), *CXXFLAGS, str(SOURCE), "-o", str(tmp), *LDFLAGS]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:  # the compiler is not there
        raise RuntimeError(f"native locator: cannot run {cmd[0]!r}: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native locator: {' '.join(cmd)} failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def load() -> ctypes.CDLL:
    """The locator library, built on first call, its entry point typed."""
    path = build()
    lib = _libs.get(path)
    if lib is None:
        lib = ctypes.CDLL(str(path))
        lib.meshcore_locate.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ]
        lib.meshcore_locate.restype = None
        _libs[path] = lib
    return lib


def locate(pos: np.ndarray, faces: np.ndarray, grid_x: np.ndarray, grid_y: np.ndarray,
           n_threads: int = 0) -> np.ndarray:
    """Per-pixel containing-triangle index (-1 outside); ``n_threads`` 0:
    one a hardware thread."""
    lib = load()
    pos = np.ascontiguousarray(pos, np.float64)
    faces = np.ascontiguousarray(faces, np.int32)
    grid_x = np.ascontiguousarray(grid_x, np.float32)
    grid_y = np.ascontiguousarray(grid_y, np.float32)
    h, w = grid_x.shape
    out = np.empty((h, w), np.int32)
    lib.meshcore_locate(
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(pos),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(faces),
        grid_x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        grid_y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_threads,
    )
    return out
