"""Build and load the package's CUDA kernels (``csrc/*.cu``).

At first use the sources (``*.cu``; shared ``*.cuh`` headers are included
by them) are compiled by ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, under
``fluid_llm_tpu_torch/_build/`` and keyed by a hash of the sources and
flags, then loaded with ``ctypes``.  A later process with the same sources
reuses the library.  A failed build raises; nothing is downloaded and
nothing outside this package is compiled.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C entry points and their argument types (pointers and the stream as void*)
SIGNATURES = {
    "exact_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _LL, _LL,
                            ctypes.c_float, _P],
    "flash_attention_fwd": [_P] * 6 + [_I] * 4 + [_LL] * 4 + [ctypes.c_float, _P],
    "flash_attention_dq": [_P] * 8 + [_I] * 4 + [_LL] * 5 + [ctypes.c_float, _P],
    "flash_attention_dkv": [_P] * 9 + [_I] * 4 + [_LL] * 6 + [ctypes.c_float, _P],
    "grid_slot_attention_fwd": [_P] * 4 + [_I] * 11 + [_P],
    "grid_slot_attention_bwd": [_P] * 8 + [_I] * 9 + [_P],
    "slab_decode_attention": [_P] * 9 + [_I] * 6 + [_LL, _I, ctypes.c_float, _I, _I, _P],
    "quant_matmul_w8a8": [_P, _LL] + [_P] * 4 + [_I] * 5 + [_P],
    "quant_matmul_w8a16": [_P, _LL] + [_P] * 4 + [_I] * 5 + [_P],
    "segment_sum_f32": [_P] * 5 + [_I] * 3 + [_P],
    "segment_gather_f32": [_P] * 3 + [_LL] + [_I] * 6 + [_P],
    "segment_sum_bf16": [_P] * 5 + [_I] * 3 + [_P],
    "segment_gather_bf16": [_P] * 3 + [_LL] + [_I] * 6 + [_P],
    "indexed_linear_bf16": [_P, _LL, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
    "short_attention_fwd": [_P] * 5 + [_I] * 4 + [_LL] * 4 + [ctypes.c_float, _I, _P],
}

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {cuda_home}/bin)")
    return path


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Keyed by the flags and every source, headers (``*.cuh``) included."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfluid_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists.

    One ``nvcc -c`` per source, all started together, then one link.
    Writes the compilers' output (``-Xptxas -v``: registers, shared memory,
    spills per kernel) beside the library as ``<name>.log``.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_sources(), objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [proc.communicate()[0] for proc in procs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
    if all(proc.returncode == 0 for proc in procs):
        res = subprocess.run(link, capture_output=True, text=True)
        cmds.append(link)
        logs.append(res.stdout + res.stderr)
        failed = res.returncode != 0
    else:
        failed = True
    text = "".join(" ".join(cmd) + "\n" + log for cmd, log in zip(cmds, logs))
    out.with_suffix(".log").write_text(text)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed:\n{text}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first call, with every entry point typed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [_I]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# streaming multiprocessors of an H100 SXM: the launch plans' default wave
H100_SMS = 132


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of ``device``: the wave the launch plans fill."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        text = load().cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {text}")
