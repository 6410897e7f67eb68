"""Build and bind the CUDA kernel libraries.

Each ``*.cu`` source in ``zerocaf_tpu_torch/csrc`` is compiled at first use
with ``nvcc`` for ``sm_90a`` into a shared library of its own with a plain C
interface, ``_build/lib<stem>_<hash>.so``, where ``<hash>`` is the hash of
all the sources (headers included); all sources compile at once, one
``nvcc`` process each.  The libraries are loaded with ``ctypes``; nothing
here runs at import.  Each library's ``-Xptxas -v`` report (registers,
spills) is kept beside it as ``.log``.
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

_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
# Every launcher's argument types, by the library (source stem) that holds it.
SIGNATURES = {
    "field_kernels": {
        "zc_mul": [_ptr, _ptr, _ptr, _i32, _i32, _ptr],
        "zc_pow": [_ptr, _ptr, _ptr, _i32, _i32, _i32, _ptr],
        "zc_ladder": [_ptr, _ptr, _i32, _i32, _i32, _ptr, _ptr, _i32, _ptr],
        "zc_padd": [*[_ptr] * 4, _i32, _i32, *[_ptr] * 4, _i32, _i32, _ptr,
                    _i32, _i32, _ptr],
        "zc_comb": [_ptr, _ptr, _i32, _i32, _i32, _i32, _i32, _ptr, _i32, _ptr],
    },
    "msm_kernels": {
        "zc_to_field32": [_ptr, _ptr, _i32, _ptr],
        "zc_bucket_accum": [_ptr, _ptr, _ptr, _i32, _i32, _i32, _i32, _ptr],
        "zc_combine": [_ptr, _ptr, _ptr, _i32, _i32, _i32, _i32, _ptr],
        "zc_mul_chain": [_ptr, _i32, _ptr],
    },
}

_libs: dict[str, ctypes.CDLL] = {}
_initialized: set[tuple[str, int]] = set()


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for f in sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_paths() -> dict[str, Path]:
    """The library of each ``.cu`` source, by source stem."""
    digest = source_hash()
    return {f.stem: BUILD_DIR / f"lib{f.stem}_{digest}.so"
            for f in sources() if f.suffix == ".cu"}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or DEFAULT_NVCC
    if not Path(nvcc).exists():
        raise RuntimeError(f"nvcc not found (looked on PATH and at {nvcc}); "
                           "the CUDA kernels cannot be built")
    return nvcc


def build() -> tuple[dict[str, Path], float, str]:
    """Compile every library that this hash has not built yet, all at once.
    Returns (paths by stem, wall seconds spent compiling, ptxas reports)."""
    paths = library_paths()
    missing = {stem: p for stem, p in paths.items() if not p.exists()}
    seconds = 0.0
    if missing:
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        try:
            for stem, out in missing.items():
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                procs[stem] = (tmp, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            outputs = {stem: p.communicate()[0] for stem, (_, p) in procs.items()}
        finally:
            for _, p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        seconds = time.perf_counter() - t0
        failed = [s for s, (_, p) in procs.items() if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {s}.cu (exit code {procs[s][1].returncode})\n{outputs[s]}"
                for s in failed))
        for stem, (tmp, _) in procs.items():
            paths[stem].with_suffix(".log").write_text(outputs[stem])
            os.replace(tmp, paths[stem])
    logs = [p.with_suffix(".log") for p in paths.values()]
    return paths, seconds, "".join(f.read_text() for f in logs if f.exists())


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({lib.zc_error_string(rc).decode()})")


def _declare(lib: ctypes.CDLL, stem: str) -> None:
    for name, argtypes in SIGNATURES[stem].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.zc_init.argtypes = [_ptr] * 2
    lib.zc_init.restype = ctypes.c_int
    lib.zc_error_string.argtypes = [_i32]
    lib.zc_error_string.restype = ctypes.c_char_p


def load(device: torch.device, stem: str) -> ctypes.CDLL:
    """The library built from ``csrc/<stem>.cu`` (all libraries are built if
    needed), with its constant memory written on ``device``.  Raises if it
    cannot be built or loaded."""
    if stem not in _libs:
        paths, _, _ = build()
        lib = ctypes.CDLL(str(paths[stem]))
        _declare(lib, stem)
        _libs[stem] = lib
    lib = _libs[stem]
    index = device.index if device.index is not None else torch.cuda.current_device()
    if (stem, index) not in _initialized:
        consts = [np.ascontiguousarray(a, dtype=np.int32)
                  for a in (C.FOLD_C_P_LIMBS, C.FOLD_C_R_LIMBS)]
        with torch.cuda.device(index):
            rc = lib.zc_init(*[a.ctypes.data_as(ctypes.c_void_p) for a in consts])
        check(lib, rc, f"zc_init ({stem})")
        _initialized.add((stem, index))
    return lib


def launch(name: str, device: torch.device, stem: str, fn_name: str,
           *args) -> None:
    """Call the launcher ``fn_name`` of library ``stem`` on ``device``'s
    current stream and raise if the launch was refused.  Tensors pass as
    their data pointers, everything else as a C int."""
    lib = load(device, stem)
    cargs = []
    for a in args:
        if isinstance(a, torch.Tensor):
            cargs.append(ctypes.c_void_p(a.data_ptr()))
        else:
            cargs.append(ctypes.c_int(int(a)))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(*cargs, ctypes.c_void_p(stream))
    check(lib, rc, name)
