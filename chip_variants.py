#!/usr/bin/env python3
"""Time the variants of the kernels K2 (k_pow) and K8 (k_combine) side by
side on one CUDA card, with the parent commit's kernels, and compare the
SASS of the parent's and this tree's other kernels on the 8 x 32-bit core.

    python3 chip_variants.py --parent DIR [--out FILE]

DIR holds a checkout of the parent commit (its zerocaf_tpu_torch/csrc).
Every library is compiled here, one nvcc process each, all at once, into
zerocaf_tpu_torch/_build/variants/: the parent's field_kernels.cu and
msm_kernels.cu, this tree's, and this tree's with one change each:

  * pow128:   k_pow at 128 threads a block (61,440 B of table a block);
  * mulsq:    squares by the multiply (fe_sq) in k_pow's chain and in
              k_combine's doublings, where this tree takes the SOS square
              (fe_sq_sos);
  * unrolled: the core's multiply with its loop over b's words unrolled;
  * thread1:  K8 with one thread a point operation on the core (padd_ext
              and pdbl of field32.cuh; quad 0's Horner on thread 0).

Each variant's output is held equal to this tree's kernel (the parent's to
its canonical limbs), then the kernels are timed by CUDA events in turns:
parent, this tree, this tree, parent (variants after).  Prints one line a
comparison and writes every number as JSON to FILE (default
zerocaf_tpu_torch/_build/variants/variants.json).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from chip_smoke import cuda_ms, ptxas_report, sass_counts

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "zerocaf_tpu_torch" / "_build" / "variants"
SEED = 20261017
NWIN, NB, C = 42, 33, 6             # K8 at Engine.msm's shape (c = 6)
SMALL, BIG = 1 << 15, 1 << 20       # K2's lanes: dh / hash_to_group, msm decode
CORE_KERNELS = ("k_bucket_accum", "k_padd", "k_ladder")

# K8 with one thread a point operation: thread w runs window w's running
# sum with padd_ext, thread 0 Horner with pdbl and padd_ext, on bucket
# sums converted into the core's form at entry (T as T: padd_ext takes d).
THREAD1 = r'''
#include <cuda_runtime.h>
#include "field.cuh"
#include "field32.cuh"
#include "init.cuh"
namespace zv {
__device__ zc32::Pt load(const uint32_t* p) {
  zc32::Pt r;
  for (int f = 0; f < 32; ++f) zc32::pt_word(r, f) = p[f];
  return r;
}
__global__ void __launch_bounds__(128)
    k_combine1(const int32_t* tbl, uint32_t* cv, int32_t* out, int nwin, int nb,
               int c, int tail) {
  __shared__ zc32::Pt tot_s[128];
  const int w = threadIdx.x;
  for (int e = threadIdx.x; e < nwin * nb * 4; e += blockDim.x) {
    int32_t v[zc::L];
    for (int k = 0; k < zc::L; ++k) v[k] = tbl[(size_t)e * zc::L + k];
    const zc32::Fe f = zc32::to_mont(zc32::from_limbs(v));
    for (int i = 0; i < 8; ++i) cv[(size_t)e * 8 + i] = f.w[i];
  }
  __syncthreads();
  zc32::Pt id;
  id.X = zc32::fe_zero(); id.Y = zc32::fe_one(); id.Z = zc32::fe_one();
  id.T = zc32::fe_zero();
  if (w < nwin) {
    zc32::Pt acc = id, tot = id;
    for (int b = nb - 1; b >= 1; --b) {
      const zc32::Pt S = load(cv + ((size_t)w * nb + b) * 32);
      zc32::padd_ext(acc, acc, S, zc32::c_d32);
      zc32::padd_ext(tot, tot, acc, zc32::c_d32);
    }
    tot_s[w] = tot;
  }
  __syncthreads();
  if (w != 0) return;
  zc32::Pt T = id;
  for (int s = nwin - 1; s >= 0; --s) {
    for (int i = 0; i < c; ++i) zc32::pdbl(T, i == c - 1);
    zc32::padd_ext(T, T, tot_s[s], zc32::c_d32);
  }
  for (int i = 0; i < tail; ++i) zc32::pdbl(T, i == tail - 1);
  for (int k = 0; k < 4; ++k) {
    int32_t x[zc::L];
    zc32::to_limbs(zc32::coord(T, k), x);
    for (int i = 0; i < zc::L; ++i) out[k * zc::L + i] = x[i];
  }
}
}  // namespace zv
extern "C" int zv_combine1(const int32_t* tbl, int32_t* cv, int32_t* out,
                           int nwin, int nb, int c, int tail, void* stream) {
  zv::k_combine1<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      tbl, reinterpret_cast<uint32_t*>(cv), out, nwin, nb, c, tail);
  return static_cast<int>(cudaGetLastError());
}
'''


def variant_tree(name: str, csrc: Path, edits: dict[str, tuple[str, str]]) -> Path:
    """A copy of csrc under OUT_DIR/name with each edit (file: (old, new))
    made once; raises if an edit's text is not there."""
    d = OUT_DIR / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(csrc, d)
    for fname, (old, new) in edits.items():
        text = (d / fname).read_text()
        if old not in text:
            raise RuntimeError(f"{name}: {old!r} not in {fname}")
        (d / fname).write_text(text.replace(old, new, 1))
    return d


def build_all(sources: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    """nvcc every source at once (the port's flags); returns the loaded
    libraries by name."""
    from zerocaf_tpu_torch.ops.kernels import build

    nvcc = build.find_nvcc()
    procs = {}
    for name, src in sources.items():
        so = OUT_DIR / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        (OUT_DIR / f"{name}.log").write_text(log)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def init(lib: ctypes.CDLL, parent: bool) -> None:
    """Write a library's constant memory, as build.load does (the parent's
    zc_init also took the curve's d and 2d)."""
    from zerocaf_tpu_torch import constants as C_

    arrays = (C_.FOLD_C_P_LIMBS, C_.FOLD_C_R_LIMBS)
    if parent:
        arrays += (C_.EDWARDS_D_LIMBS, C_.EDWARDS_2D_LIMBS)
    consts = [np.ascontiguousarray(a, dtype=np.int32) for a in arrays]
    lib.zc_init.argtypes = [ctypes.c_void_p] * len(consts)
    if lib.zc_init(*[a.ctypes.data_as(ctypes.c_void_p) for a in consts]):
        raise RuntimeError("zc_init failed")


def call(lib, fn: str, *args) -> None:
    """Launch fn on the current stream; tensors pass as pointers, the rest
    as C ints; raises on a refused launch."""
    c = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
         else ctypes.c_int(int(a)) for a in args]
    rc = getattr(lib, fn)(*c, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc:
        raise RuntimeError(f"{fn}: CUDA error {rc}")


def in_turns(fns: dict[str, object], order: list[str], reps: int) -> dict[str, list]:
    """Each named launcher timed in the given order (names may repeat)."""
    times: dict[str, list] = {k: [] for k in fns}
    for k in order:
        times[k].append(cuda_ms(fns[k], reps))
    return times


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="a checkout of the parent commit")
    ap.add_argument("--out", type=Path, default=OUT_DIR / "variants.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_variants.py needs a CUDA device")
    from zerocaf_tpu_torch import constants as C_
    from zerocaf_tpu_torch import oracle as o
    from zerocaf_tpu_torch.ops import limb
    from zerocaf_tpu_torch.ops.kernels import field_kernels as fk

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    csrc = ROOT / "zerocaf_tpu_torch" / "csrc"
    pcsrc = args.parent / "zerocaf_tpu_torch" / "csrc"
    pow128 = variant_tree("pow128", csrc, {"field_kernels.cu": (
        "constexpr int POW_BLOCK = 64;", "constexpr int POW_BLOCK = 128;")})
    mulsq = variant_tree("mulsq", csrc, {
        "pow32.cuh": ("r = fe_sq_sos<M>(r);", "r = fe_sq<M>(r);"),
        "quad32.cuh": ("const Fe sq = fe_sq_sos(op);", "const Fe sq = fe_sq(op);")})
    unrolled = variant_tree("unrolled", csrc, {"field32.cuh": (
        "#pragma unroll 1\n  for (int i = 0; i < NW; ++i) {\n    const uint32_t bi",
        "#pragma unroll\n  for (int i = 0; i < NW; ++i) {\n    const uint32_t bi")})
    thread1 = variant_tree("thread1", csrc, {})
    (thread1 / "combine1.cu").write_text(THREAD1)
    libs = build_all({
        "parent_field": pcsrc / "field_kernels.cu",
        "parent_msm": pcsrc / "msm_kernels.cu",
        "field": csrc / "field_kernels.cu", "msm": csrc / "msm_kernels.cu",
        "pow128": pow128 / "field_kernels.cu", "unrolled": unrolled / "msm_kernels.cu",
        "mulsq_field": mulsq / "field_kernels.cu", "mulsq_msm": mulsq / "msm_kernels.cu",
        "thread1": thread1 / "combine1.cu"})
    for name, lib in libs.items():
        init(lib, name.startswith("parent"))
    res = {"card": card}

    # SASS of the other kernels on the core: the parent's and this tree's
    for kernel in CORE_KERNELS:
        stem = "msm" if kernel == "k_bucket_accum" else "field"
        old = sass_counts(OUT_DIR / f"libparent_{stem}.so", kernel)
        new = sass_counts(OUT_DIR / f"lib{stem}.so", kernel)
        for name in sorted(set(old) | set(new)):
            print(f"[sass] {name}: parent {old.get(name)}, this tree {new.get(name)}"
                  f" ({'the same' if old.get(name) == new.get(name) else 'differs'})")
            res[f"sass {name}"] = {"parent": old.get(name), "tree": new.get(name)}

    # K2 at e = (p-5)/8: parent (22 x 12, global table), this tree, pow128,
    # mulsq
    rng = np.random.default_rng(SEED)
    vals = [int.from_bytes(rng.bytes(32), "little") % o.P for _ in range(2 * SMALL)]
    limbs = torch.tensor(np.stack([o.int_to_limbs(v) for v in vals]).astype(np.int32),
                         device=dev)
    x = limb.sub(fk.mul_tiled_ref(limbs[:SMALL], limbs[SMALL:]), limbs[:SMALL])
    e = C_.EXP_SQRT_RATIO
    digits = torch.tensor(fk.pow_digits(e), dtype=torch.int32, device=dev)
    for lanes in (SMALL, BIG):
        a = x.repeat(lanes // SMALL, 1).contiguous()
        outs = {k: torch.empty_like(a) for k in ("parent", "tree", "pow128", "mulsq")}
        scratch = torch.empty((16, 22, lanes), dtype=torch.int32, device=dev)
        fns = {"parent": lambda: call(libs["parent_field"], "zc_pow", a, outs["parent"],
                                      scratch, digits, digits.numel(), lanes, 0),
               "tree": lambda: call(libs["field"], "zc_pow", a, outs["tree"], digits,
                                    digits.numel(), lanes, 0),
               "pow128": lambda: call(libs["pow128"], "zc_pow", a, outs["pow128"],
                                      digits, digits.numel(), lanes, 0),
               "mulsq": lambda: call(libs["mulsq_field"], "zc_pow", a, outs["mulsq"],
                                     digits, digits.numel(), lanes, 0)}
        for f in fns.values():
            f()
        torch.cuda.synchronize()
        same = (torch.equal(limb.canonical(outs["parent"], limb.FIELD), outs["tree"])
                and torch.equal(outs["pow128"], outs["tree"])
                and torch.equal(outs["mulsq"], outs["tree"]))
        if not same:
            raise AssertionError(f"K2 variants differ at {lanes} lanes")
        t = in_turns(fns, ["parent", "tree", "tree", "parent", "pow128", "pow128",
                           "mulsq", "mulsq", "tree"], 5 if lanes == BIG else 20)
        print(f"[K2] e=(p-5)/8, {lanes} lanes, equal outputs: " + ", ".join(
            f"{k} {v}" for k, v in t.items()) + " ms", flush=True)
        res[f"K2 {lanes}"] = t
        del scratch, outs, a

    # K8 at nwin 42, nb 33, c 6 on random points' tables; then the strided
    # shape of rank 3 of 4 (11 windows, 24 doublings a window, tail 18)
    import zerocaf_tpu_torch as zt

    pts = zt.RistrettoPoint.from_uniform_bytes(torch.as_tensor(
        rng.integers(0, 256, (NWIN * NB, 64), dtype=np.uint8)).to(dev)).point._tuple()
    tbl = torch.stack(pts, dim=1).reshape(NWIN, NB, 4, 22).contiguous()
    for nwin, c, tail in ((NWIN, C, 0), (11, 4 * C, 3 * C)):
        t8 = tbl[:nwin].contiguous()
        cv = torch.empty((nwin, NB, 4, 8), dtype=torch.int32, device=dev)
        outs = {k: torch.empty((4, 22), dtype=torch.int32, device=dev)
                for k in ("parent", "tree", "unrolled", "thread1", "mulsq")}
        fns = {"tree": lambda: call(libs["msm"], "zc_combine", t8, cv, outs["tree"],
                                    nwin, NB, c, tail),
               "unrolled": lambda: call(libs["unrolled"], "zc_combine", t8, cv,
                                        outs["unrolled"], nwin, NB, c, tail),
               "thread1": lambda: call(libs["thread1"], "zv_combine1", t8, cv,
                                       outs["thread1"], nwin, NB, c, tail),
               "mulsq": lambda: call(libs["mulsq_msm"], "zc_combine", t8, cv, outs["mulsq"],
                                   nwin, NB, c, tail)}
        if tail == 0:
            fns["parent"] = lambda: call(libs["parent_msm"], "zc_combine", t8,
                                         outs["parent"], nwin, NB, c)
        for f in fns.values():
            f()
        torch.cuda.synchronize()
        same = all(torch.equal(outs[k], outs["tree"])
                   for k in ("unrolled", "thread1", "mulsq"))
        if tail == 0:
            same &= torch.equal(limb.canonical(outs["parent"], limb.FIELD), outs["tree"])
        if not same:
            raise AssertionError(f"K8 variants differ (nwin {nwin}, tail {tail})")
        order = (["parent", "tree", "tree", "parent"] if tail == 0 else ["tree"] * 2)
        t = in_turns(fns, order + ["unrolled", "unrolled", "thread1", "thread1", "mulsq",
                                   "mulsq", "tree"], 5)
        print(f"[K8] nwin {nwin}, nb {NB}, c {c}, tail {tail}, equal outputs: "
              + ", ".join(f"{k} {v}" for k, v in t.items()) + " ms", flush=True)
        res[f"K8 nwin {nwin} tail {tail}"] = t

    # one dependent multiply: rolled (this tree) and unrolled
    for name in ("msm", "unrolled"):
        xw = torch.tensor(np.arange(1, 17, dtype=np.int32), device=dev)
        ms = cuda_ms(lambda: call(libs[name], "zc_mul_chain", xw, 4096), 3)
        print(f"[mul chain] {name}: {ms * 1e3 / 4096:.4f} us a dependent multiply")
        res[f"mul latency us {name}"] = ms * 1e3 / 4096
    for name in ("pow128", "unrolled", "thread1", "mulsq_field", "mulsq_msm"):
        report = ptxas_report((OUT_DIR / f"{name}.log").read_text())
        for fn, r in report.items():
            if any(k in fn for k in ("k_pow", "k_combine", "k_mul_chain")):
                print(f"[ptxas] {name} {fn}: {r.get('registers')} registers, "
                      f"{r.get('spill_stores')} B spill stores")
                res[f"ptxas {name} {fn}"] = r
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
