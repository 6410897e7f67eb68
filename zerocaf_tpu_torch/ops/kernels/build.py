"""Build and bind the CUDA kernel library.

The sources in ``zerocaf_tpu_torch/csrc`` are compiled at first use with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
``_build/libzerocaf_kernels_<hash>.so``, where ``<hash>`` is the hash of the
sources; the library is loaded with ``ctypes``.  Nothing here runs at import.
The ``-Xptxas -v`` report (registers, spills) is kept beside the library as
``.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ... import constants as C

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_lib: ctypes.CDLL | None = None
_initialized_devices: set[int] = set()


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for f in sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libzerocaf_kernels_{source_hash()}.so"


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or DEFAULT_NVCC
    if not Path(nvcc).exists():
        raise RuntimeError(f"nvcc not found (looked on PATH and at {nvcc}); "
                           "the CUDA kernels cannot be built")
    return nvcc


def build() -> tuple[Path, float, str]:
    """Compile the library unless this hash is already built.  Returns
    (path, seconds spent compiling, ptxas report)."""
    out = library_path()
    log = out.with_suffix(".log")
    if out.exists():
        return out, 0.0, log.read_text() if log.exists() else ""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cu = [str(f) for f in sources() if f.suffix == ".cu"]
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), *cu],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out, seconds, proc.stdout + proc.stderr


def _declare(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    signatures = {
        "zc_init": [ptr, ptr, ptr, ptr],
        "zc_mul": [ptr, ptr, ptr, i32, i32, ptr],
        "zc_pow": [ptr, ptr, ptr, ptr, i32, i32, i32, ptr],
        "zc_ladder": [ptr, ptr, i32, i32, i32, ptr, ptr, i32, ptr],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.zc_error_string.argtypes = [i32]
    lib.zc_error_string.restype = ctypes.c_char_p


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({lib.zc_error_string(rc).decode()})")


def load(device: torch.device) -> ctypes.CDLL:
    """The kernel library, built if needed, with its constant memory
    written on ``device``.  Raises if it cannot be built or loaded."""
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        _declare(lib)
        _lib = lib
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _initialized_devices:
        consts = [np.ascontiguousarray(a, dtype=np.int32) for a in (
            C.FOLD_C_P_LIMBS, C.FOLD_C_R_LIMBS, C.EDWARDS_D_LIMBS,
            C.EDWARDS_2D_LIMBS)]
        with torch.cuda.device(index):
            rc = _lib.zc_init(*[a.ctypes.data_as(ctypes.c_void_p) for a in consts])
        check(_lib, rc, "zc_init")
        _initialized_devices.add(index)
    return _lib
