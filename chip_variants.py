#!/usr/bin/env python3
"""Time the variants of the kernels K1 (k_mul), K6 (k_comb), K2 (k_pow)
and K8 (k_combine) side by side on one CUDA card, with the parent commit's
kernels, and compare the SASS of the parent's and this tree's other
kernels on the 8 x 32-bit core.

    python3 chip_variants.py --parent DIR [--out FILE]

DIR holds a checkout of the parent commit (its zerocaf_tpu_torch/csrc; at
commit 3c25b7d, K1 and K6 on the 22 x 12-bit limbs of its field.cuh).
Every library is compiled here, one nvcc process each, all at once, into
zerocaf_tpu_torch/_build/variants/: the parent's field_kernels.cu and
msm_kernels.cu, this tree's, and this tree's with one change each:

  * direct:   K1 with each thread loading its own rows from device memory
              in 8-byte pieces, where this tree stages the block's tiles
              through shared memory in 16-byte pieces;
  * words:    K1 (this tree's kernel) on operands that start one lane into
              their buffers: not 16-byte aligned, so the tiles are copied
              word by word;
  * ilp:      K6 with each round of its independent multiplies (PP, MM,
              TT; then X, Y, Z, T) in one rolled loop, their steps side by
              side (fe_mul_n), where this tree runs them one after the
              other;
  * quad:     K6 with a quad of four threads a lane, each holding one
              coordinate of Q, two rounds of one multiply a thread
              (k_combine's form, quad32.cuh);
  * pow128:   k_pow at 128 threads a block (61,440 B of table a block);
  * mulsq:    squares by the multiply (fe_sq) in k_pow's chain and in
              k_combine's doublings, where this tree takes the SOS square
              (fe_sq_sos);
  * unrolled: the core's multiply with its loop over b's words unrolled;
  * thread1:  K8 with one thread a point operation on the core (padd_ext
              and pdbl of field32.cuh; quad 0's Horner on thread 0).

Each variant's output is held equal to this tree's kernel (the parent's K1
and K6 to their canonical limbs), then the kernels are timed by CUDA events
in turns: parent, this tree, this tree, parent (variants after), each over
back-to-back launches; K1's and K6's parent and tree are timed in turns a
second time, replayed from a CUDA graph (no host work between launches).  Prints
one line a comparison and writes every number as JSON to FILE (default
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

from chip_smoke import cuda_ms, graph_ms, ptxas_report, sass_counts

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "zerocaf_tpu_torch" / "_build" / "variants"
SEED = 20261017
NWIN, NB, C = 42, 33, 6             # K8 at Engine.msm's shape (c = 6)
SMALL, BIG = 1 << 15, 1 << 20       # K1's and K2's lanes: dh, msm decode
CORE_KERNELS = ("k_bucket_accum", "k_padd", "k_ladder", "k_pow", "k_combine")
COMB_CASES = ((14, True, "packed2"), (8, False, "rows"))   # keygen's, unsigned

# K1 with per-thread 8-byte loads of its rows from device memory; K6 with
# its rounds of independent multiplies interleaved (ilp) and on a quad.
VARIANTS = r'''
#include <cuda_runtime.h>
#include "comb32.cuh"
#include "field32.cuh"
#include "init.cuh"
#include "quad32.cuh"
namespace zv {
using namespace zc32;
constexpr int L = NL;
// N independent Montgomery products r[k] = a[k] b[k] R^-1 mod m in one
// rolled loop of 8 steps, the N products' mont_step side by side.
template <int N, class M = ModP>
__device__ __forceinline__ void fe_mul_n(Fe (&r)[N], const Fe (&a)[N],
                                                  const Fe (&b)[N]) {
  uint32_t t[N][NW + 2], bw[N][NW];
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int j = 0; j < NW + 2; ++j) t[k][j] = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) bw[k][j] = b[k].w[j];
  }
#pragma unroll 1
  for (int i = 0; i < NW; ++i) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const uint32_t bi = bw[k][0];
#pragma unroll
      for (int j = 0; j < NW - 1; ++j) bw[k][j] = bw[k][j + 1];
      mont_step<M>(t[k], a[k], bi);
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    uint32_t lo[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) lo[j] = t[k][j];
    r[k] = sub_p_if_geq<M>(lo, t[k][NW]);
  }
}

// comb32.cuh's madd_affine with each round of independent multiplies as
// one fe_mul_n.
__device__ __forceinline__ void madd_affine_ilp(Pt& Q, const Fe (&f)[3]) {
  const Fe l1[3] = {fe_add(Q.Y, Q.X), fe_sub(Q.Y, Q.X), Q.T};
  Fe p[3];                                           // PP, MM, TT
  fe_mul_n<3>(p, l1, f);
  const Fe Z2 = fe_add(Q.Z, Q.Z);
  const Fe E = fe_sub(p[0], p[1]), F = fe_sub(Z2, p[2]), G = fe_add(Z2, p[2]),
           H = fe_add(p[0], p[1]);
  const Fe l2[4] = {E, G, F, E}, r2[4] = {F, H, G, H};
  Fe q[4];
  fe_mul_n<4>(q, l2, r2);
  Q.X = q[0]; Q.Y = q[1]; Q.Z = q[2]; Q.T = q[3];
}
// The quad's addition: role j holds coordinate j; round 1 gives MM, PP,
// TT and 2Z (Z times the Montgomery two), then E, H, F, G, then round 2.
template <class X>
__device__ __forceinline__ void quad_madd_affine(Fe& v, const Fe& f, int j,
                                                 const X& x) {
  const Fe a = x(v, quad_add_a(j));
  const Fe b = x(v, quad_add_b(j));
  const Fe p = fe_mul(quad_operand(a, b, j), f);
  const Fe lo = x(p, j & 2), hi = x(p, (j & 2) + 1);
  v = quad_round2(fe_pick(j & 1, fe_add(hi, lo), fe_sub(hi, lo)), j, x);
}
__device__ __forceinline__ int comb_digit(const int32_t* wl, int w, int full, int h,
                                          int is_signed, int& carry) {
  int d = __ldg(wl + w) & (full - 1);
  if (is_signed) { d += carry; carry = d >= h; d -= carry * full; }
  return d;
}
__global__ void __launch_bounds__(128)
    k_comb_quad(const uint32_t* __restrict__ tbl, const int32_t* __restrict__ win,
                int nwin, int width, int is_signed, int nent,
                int32_t* __restrict__ out, int n) {
  const size_t lane = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 2;
  if (lane >= (size_t)n) return;
  const int j = threadIdx.x & 3;
  const unsigned mask = 0xfu << (threadIdx.x & 28);
  const auto x = [&](const Fe& v, int s) {
    Fe r;
    for (int i = 0; i < NW; ++i) r.w[i] = __shfl_sync(mask, v.w[i], s, 4);
    return r;
  };
  const Fe one = fe_one(), two = fe_add(one, one);
  const int32_t* wl = win + lane * nwin;
  const int h = 1 << (width - 1), full = 1 << width;
  Fe v = fe_pick(j == 1 || j == 2, one, fe_zero());
  int carry = 0;
  for (int w = 0; w < nwin; ++w) {
    const int d = comb_digit(wl, w, full, h, is_signed, carry);
    const int neg = d < 0, s = -neg, a = (d ^ s) - s;
    const int c = j >= 2 ? 2 : j ^ 1 ^ neg;      // y-x, y+x (swapped if neg), 2dxy
    const uint4* e = reinterpret_cast<const uint4*>(tbl + ((size_t)w * nent + a) * 24 + c * 8);
    const uint4 lo = __ldg(e), hi = __ldg(e + 1);
    const Fe f = {{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
    quad_madd_affine(v, fe_pick(j == 3, two, fe_pick(j == 2 && neg, fe_neg(f), f)), j, x);
  }
  int32_t limbs[L];
  to_limbs(v, limbs);
  for (int k = 0; k < L; ++k) out[((size_t)j * n + lane) * L + k] = limbs[k];
}
template <class M>
__global__ void __launch_bounds__(128)
    k_mul_direct(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                 int32_t* __restrict__ out, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const int2* pa = reinterpret_cast<const int2*>(a + (size_t)lane * L);
  const int2* pb = reinterpret_cast<const int2*>(b + (size_t)lane * L);
  int32_t x[L], y[L], z[L];
  for (int k = 0; k < L / 2; ++k) {
    const int2 u = __ldg(pa + k), v = __ldg(pb + k);
    x[2 * k] = u.x; x[2 * k + 1] = u.y; y[2 * k] = v.x; y[2 * k + 1] = v.y;
  }
  zc32::pack_limbs(zc32::mul_limbs<M>(x, y), z);
  int2* po = reinterpret_cast<int2*>(out + (size_t)lane * L);
  for (int k = 0; k < L / 2; ++k) po[k] = make_int2(z[2 * k], z[2 * k + 1]);
}
__global__ void __launch_bounds__(128)
    k_comb_ilp(const uint32_t* __restrict__ tbl, const int32_t* __restrict__ win,
            int nwin, int width, int is_signed, int nent,
            int32_t* __restrict__ out, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const int32_t* wl = win + (size_t)lane * nwin;
  const int h = 1 << (width - 1), full = 1 << width;
  Pt Q;
  Q.X = fe_zero(); Q.Y = fe_one(); Q.Z = fe_one(); Q.T = fe_zero();
  int carry = 0;
  for (int w = 0; w < nwin; ++w) {
    const int d = comb_digit(wl, w, full, h, is_signed, carry);
    const int s = -(int)(d < 0), a = (d ^ s) - s;
    const uint4* e4 = reinterpret_cast<const uint4*>(tbl + ((size_t)w * nent + a) * 24);
    Fe e[3], f[3];
    for (int k = 0; k < 3; ++k) {
      const uint4 lo = __ldg(e4 + 2 * k), hi = __ldg(e4 + 2 * k + 1);
      e[k] = Fe{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
    }
    comb_factors(f, e, d < 0);
    madd_affine_ilp(Q, f);
  }
  for (int k = 0; k < 4; ++k) {
    int32_t x[L];
    to_limbs(coord(Q, k), x);
    for (int i = 0; i < L; ++i) out[((size_t)k * n + lane) * L + i] = x[i];
  }
}
}  // namespace zv
extern "C" int zv_mul(const int32_t* a, const int32_t* b, int32_t* out, int n,
                      int spec, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (spec) zv::k_mul_direct<zc32::ModR><<<(n + 127) / 128, 128, 0, s>>>(a, b, out, n);
  else zv::k_mul_direct<zc32::ModP><<<(n + 127) / 128, 128, 0, s>>>(a, b, out, n);
  return static_cast<int>(cudaGetLastError());
}
extern "C" int zv_comb_ilp(const int32_t* tbl, const int32_t* win, int nwin, int width,
                        int is_signed, int nent, int32_t* out, int n, void* stream) {
  zv::k_comb_ilp<<<(n + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(tbl), win, nwin, width, is_signed, nent, out, n);
  return static_cast<int>(cudaGetLastError());
}
extern "C" int zv_comb_quad(const int32_t* tbl, const int32_t* win, int nwin, int width,
                            int is_signed, int nent, int32_t* out, int n, void* stream) {
  zv::k_comb_quad<<<(4 * n + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(tbl), win, nwin, width, is_signed, nent, out, n);
  return static_cast<int>(cudaGetLastError());
}
'''

# K8 with one thread a point operation: thread w runs window w's running
# sum with padd_ext, thread 0 Horner with pdbl and padd_ext, on bucket
# sums converted into the core's form at entry (T as T: padd_ext takes d).
THREAD1 = r'''
#include <cuda_runtime.h>
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
    int32_t v[zc32::NL];
    for (int k = 0; k < zc32::NL; ++k) v[k] = tbl[(size_t)e * zc32::NL + k];
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
    int32_t x[zc32::NL];
    zc32::to_limbs(zc32::coord(T, k), x);
    for (int i = 0; i < zc32::NL; ++i) out[k * zc32::NL + i] = x[i];
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


def init_parent(lib: ctypes.CDLL) -> None:
    """Write the fold constants of p and r into a parent library's
    constant memory, as its build.load did (this tree's libraries need no
    set-up)."""
    from zerocaf_tpu_torch import constants as C_

    consts = [np.ascontiguousarray(a, dtype=np.int32)
              for a in (C_.FOLD_C_P_LIMBS, C_.FOLD_C_R_LIMBS)]
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


def in_turns(fns: dict[str, object], order: list[str], reps: int,
             timer=cuda_ms) -> dict[str, list]:
    """Each named launcher timed in the given order (names may repeat), by
    timer: back-to-back launches (cuda_ms) or their replay from a CUDA
    graph (graph_ms)."""
    times: dict[str, list] = {k: [] for k in order}
    for k in order:
        times[k].append(timer(fns[k], reps))
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
    (thread1 / "variants.cu").write_text(VARIANTS)
    libs = build_all({
        "parent_field": pcsrc / "field_kernels.cu",
        "parent_msm": pcsrc / "msm_kernels.cu",
        "field": csrc / "field_kernels.cu", "msm": csrc / "msm_kernels.cu",
        "pow128": pow128 / "field_kernels.cu", "unrolled": unrolled / "msm_kernels.cu",
        "mulsq_field": mulsq / "field_kernels.cu", "mulsq_msm": mulsq / "msm_kernels.cu",
        "thread1": thread1 / "combine1.cu", "variants": thread1 / "variants.cu"})
    for name, lib in libs.items():
        if name.startswith("parent"):
            init_parent(lib)
    res = {"card": card}

    # SASS of the other kernels on the core: the parent's and this tree's
    for kernel in CORE_KERNELS:
        stem = "msm" if kernel in ("k_bucket_accum", "k_combine") else "field"
        old = sass_counts(OUT_DIR / f"libparent_{stem}.so", kernel)
        new = sass_counts(OUT_DIR / f"lib{stem}.so", kernel)
        for name in sorted(set(old) | set(new)):
            print(f"[sass] {name}: parent {old.get(name)}, this tree {new.get(name)}"
                  f" ({'the same' if old.get(name) == new.get(name) else 'differs'})")
            res[f"sass {name}"] = {"parent": old.get(name), "tree": new.get(name)}

    rng = np.random.default_rng(SEED)
    k1_variants(libs, rng, dev, res)
    k6_variants(libs, rng, dev, res)

    # K2 at e = (p-5)/8: parent, this tree, pow128, mulsq
    vals = [int.from_bytes(rng.bytes(32), "little") % o.P for _ in range(2 * SMALL)]
    limbs = torch.tensor(np.stack([o.int_to_limbs(v) for v in vals]).astype(np.int32),
                         device=dev)
    x = limb.sub(fk.mul_tiled_ref(limbs[:SMALL], limbs[SMALL:]), limbs[:SMALL])
    e = C_.EXP_SQRT_RATIO
    digits = torch.tensor(fk.pow_digits(e), dtype=torch.int32, device=dev)
    for lanes in (SMALL, BIG):
        a = x.repeat(lanes // SMALL, 1).contiguous()
        outs = {k: torch.empty_like(a) for k in ("parent", "tree", "pow128", "mulsq")}
        fns = {"parent": lambda: call(libs["parent_field"], "zc_pow", a, outs["parent"],
                                      digits, digits.numel(), lanes, 0),
               "tree": lambda: call(libs["field"], "zc_pow", a, outs["tree"], digits,
                                    digits.numel(), lanes, 0),
               "pow128": lambda: call(libs["pow128"], "zc_pow", a, outs["pow128"],
                                      digits, digits.numel(), lanes, 0),
               "mulsq": lambda: call(libs["mulsq_field"], "zc_pow", a, outs["mulsq"],
                                     digits, digits.numel(), lanes, 0)}
        for f in fns.values():
            f()
        torch.cuda.synchronize()
        same = (torch.equal(outs["parent"], outs["tree"])
                and torch.equal(outs["pow128"], outs["tree"])
                and torch.equal(outs["mulsq"], outs["tree"]))
        if not same:
            raise AssertionError(f"K2 variants differ at {lanes} lanes")
        t = in_turns(fns, ["parent", "tree", "tree", "parent", "pow128", "pow128",
                           "mulsq", "mulsq", "tree"], 5 if lanes == BIG else 20)
        print(f"[K2] e=(p-5)/8, {lanes} lanes, equal outputs: " + ", ".join(
            f"{k} {v}" for k, v in t.items()) + " ms", flush=True)
        res[f"K2 {lanes}"] = t
        del outs, a

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
                                   nwin, NB, c, tail),
               "parent": lambda: call(libs["parent_msm"], "zc_combine", t8, cv,
                                      outs["parent"], nwin, NB, c, tail)}
        for f in fns.values():
            f()
        torch.cuda.synchronize()
        same = all(torch.equal(outs[k], outs["tree"])
                   for k in ("unrolled", "thread1", "mulsq", "parent"))
        if not same:
            raise AssertionError(f"K8 variants differ (nwin {nwin}, tail {tail})")
        t = in_turns(fns, ["parent", "tree", "tree", "parent", "unrolled", "unrolled",
                           "thread1", "thread1", "mulsq", "mulsq", "tree"], 5)
        print(f"[K8] nwin {nwin}, nb {NB}, c {c}, tail {tail}, equal outputs: "
              + ", ".join(f"{k} {v}" for k, v in t.items()) + " ms", flush=True)
        res[f"K8 nwin {nwin} tail {tail}"] = t

    # one dependent multiply: rolled (this tree) and unrolled
    for name in ("msm", "unrolled"):
        xw = torch.tensor(np.arange(1, 17, dtype=np.int32), device=dev)
        ms = cuda_ms(lambda: call(libs[name], "zc_mul_chain", xw, 4096), 3)
        print(f"[mul chain] {name}: {ms * 1e3 / 4096:.4f} us a dependent multiply")
        res[f"mul latency us {name}"] = ms * 1e3 / 4096
    for name in ("parent_field", "variants", "pow128", "unrolled", "thread1",
                 "mulsq_field", "mulsq_msm"):
        report = ptxas_report((OUT_DIR / f"{name}.log").read_text())
        for fn, r in report.items():
            if any(k in fn for k in ("k_pow", "k_comb", "k_mul")):
                print(f"[ptxas] {name} {fn}: {r.get('registers')} registers, "
                      f"{r.get('spill_stores')} B spill stores")
                res[f"ptxas {name} {fn}"] = r
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(res, indent=1))


def k1_variants(libs, rng, dev, res) -> None:
    """K1 at the main paths' shapes (32768 lanes mod p and r, 2^20 mod p):
    the parent's kernel (22 x 12, limbs to canonicalize), this tree's
    (staged tiles), direct and words, equal outputs, timed in turns."""
    from zerocaf_tpu_torch import oracle as o
    from zerocaf_tpu_torch.ops import limb
    from zerocaf_tpu_torch.ops.kernels import field_kernels as fk

    for spec, lanes in ((limb.FIELD, SMALL), (limb.SCALAR, SMALL), (limb.FIELD, BIG)):
        m = o.R if spec is limb.SCALAR else o.P
        vals = [int.from_bytes(rng.bytes(32), "little") % m for _ in range(2 * SMALL)]
        v = torch.tensor(np.stack([o.int_to_limbs(x) for x in vals]).astype(np.int32),
                         device=dev).repeat(lanes // SMALL, 1)
        a0, b0 = v[0::2].contiguous(), v[1::2].contiguous()
        a0 = limb.sub(fk.mul_tiled_ref(a0, b0, spec), a0)    # semi, maybe negative
        # the words variant: the same operands one lane into their buffers
        pad = torch.empty((2, lanes + 1, 22), dtype=torch.int32, device=dev)
        pad[0, 1:], pad[1, 1:] = a0, b0
        aw, bw = pad[0, 1:], pad[1, 1:]
        outs = {k: torch.empty_like(a0) for k in ("parent", "tree", "direct")}
        outs["words"] = torch.empty((lanes + 1, 22), dtype=torch.int32, device=dev)[1:]
        sid = spec.kernel_id
        fns = {"parent": lambda: call(libs["parent_field"], "zc_mul", a0, b0,
                                      outs["parent"], lanes, sid),
               "tree": lambda: call(libs["field"], "zc_mul", a0, b0, outs["tree"],
                                    lanes, sid),
               "direct": lambda: call(libs["variants"], "zv_mul", a0, b0,
                                      outs["direct"], lanes, sid),
               "words": lambda: call(libs["field"], "zc_mul", aw, bw, outs["words"],
                                     lanes, sid)}
        for f in fns.values():
            f()
        torch.cuda.synchronize()
        same = (torch.equal(limb.canonical(outs["parent"], spec), outs["tree"])
                and all(torch.equal(outs[k], outs["tree"]) for k in ("direct", "words")))
        if not same:
            raise AssertionError(f"K1 variants differ ({spec.name}, {lanes} lanes)")
        t = in_turns(fns, ["parent", "tree", "tree", "parent", "direct", "direct",
                           "words", "words", "tree"], 50)
        g = in_turns(fns, ["parent", "tree", "tree", "parent"], 50, graph_ms)
        key = f"K1 {spec.name} {lanes}"
        print(f"[{key}] equal outputs: " + ", ".join(f"{k} {x}" for k, x in t.items())
              + " ms; replayed from a CUDA graph: "
              + ", ".join(f"{k} {x}" for k, x in g.items()) + " ms", flush=True)
        res[key], res[f"{key} graph"] = t, g


def k6_variants(libs, rng, dev, res) -> None:
    """K6 at 32768 lanes, signed width 14 (keygen's) and unsigned width 8:
    the parent's kernel (22 x 12 on the packed or rows table, limbs to
    canonicalize), this tree's (one thread a lane on the core table), ilp
    and quad, equal outputs, timed in turns."""
    import zerocaf_tpu_torch as zt
    from zerocaf_tpu_torch.models import edwards as ed
    from zerocaf_tpu_torch.ops import limb
    from zerocaf_tpu_torch.ops.kernels import field_kernels as fk

    s = zt.Scalar.from_bytes_wide(torch.as_tensor(
        rng.integers(0, 256, (SMALL, 64), dtype=np.uint8)).to(dev))
    for width, signed, glue in COMB_CASES:
        win = s.windows(width, -(-250 // width)).contiguous()
        nwin = win.shape[-1]
        layout = fk.comb_layout(glue)
        old, core = (ed.comb_table(width, signed, lay, dev) for lay in (layout, "core"))
        nent = core.shape[1]
        outs = {k: torch.empty((4, SMALL, 22), dtype=torch.int32, device=dev)
                for k in ("parent", "tree", "ilp", "quad")}
        fns = {"parent": lambda: call(libs["parent_field"], "zc_comb", old, win, nwin,
                                      width, int(signed), nent,
                                      int(layout == "packed"), outs["parent"], SMALL),
               "tree": lambda: call(libs["field"], "zc_comb", core, win, nwin, width,
                                    int(signed), nent, outs["tree"], SMALL),
               "ilp": lambda: call(libs["variants"], "zv_comb_ilp", core, win, nwin,
                                   width, int(signed), nent, outs["ilp"], SMALL),
               "quad": lambda: call(libs["variants"], "zv_comb_quad", core, win, nwin,
                                    width, int(signed), nent, outs["quad"], SMALL)}
        for f in fns.values():
            f()
        torch.cuda.synchronize()
        same = (torch.equal(limb.canonical(outs["parent"], limb.FIELD), outs["tree"])
                and torch.equal(outs["ilp"], outs["tree"])
                and torch.equal(outs["quad"], outs["tree"]))
        if not same:
            raise AssertionError(f"K6 variants differ (width {width}, signed {signed})")
        t = in_turns(fns, ["parent", "tree", "tree", "parent", "ilp", "ilp", "quad",
                           "quad", "tree"], 20)
        g = in_turns(fns, ["parent", "tree", "tree", "parent"], 20, graph_ms)
        key = f"K6 {'signed' if signed else 'unsigned'} width {width}"
        print(f"[{key}] {SMALL} lanes, equal outputs: "
              + ", ".join(f"{k} {x}" for k, x in t.items()) + " ms; replayed from "
              "a CUDA graph: " + ", ".join(f"{k} {x}" for k, x in g.items()) + " ms",
              flush=True)
        res[key], res[f"{key} graph"] = t, g


if __name__ == "__main__":
    main()
