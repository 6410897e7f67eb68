// Hopper kernels of Pippenger MSM: K7 (bucket accumulation for all window
// groups; K9, K11 and K12 launch it too) with its prep kernel, on the
// 8 x 32-bit core of field32.cuh, and K8 (window combine) on field.cuh's
// 22 x 12-bit limbs, with a plain C launcher each (bound with ctypes by
// zerocaf_tpu_torch/ops/kernels/build.py).  Every launcher enqueues on the
// stream it is given and returns cudaGetLastError().  Each kernel agrees
// limb for limb with its plain PyTorch version
// (zerocaf_tpu_torch/ops/kernels/msm_kernels.py).

#include <cuda_runtime.h>

#include "field.cuh"
#include "field32.cuh"
#include "init.cuh"

namespace zc {

constexpr int ACCUM_BLOCK = 128;
constexpr int ACCUM_MIN_BLOCKS = 4;    // k_bucket_accum's blocks per SM
constexpr int COMBINE_THREADS = 128;   // one thread per window
constexpr int PT = 4 * L;              // int32 of one extended point

// One extended point stored as 88 contiguous int32 (X, Y, Z, T limbs).
// The flat index is a compile-time constant under the unrolled loops, so
// the select resolves statically.
__device__ __forceinline__ int32_t& pt_limb(Pt& p, int f) {
  return f < L ? p.X.v[f] : f < 2 * L ? p.Y.v[f - L]
       : f < 3 * L ? p.Z.v[f - 2 * L] : p.T.v[f - 3 * L];
}

// 16-byte loads and stores of a contiguous point (352 bytes, 16-byte
// aligned: every table entry starts at a multiple of 352 bytes).
__device__ __forceinline__ void pt_load(Pt& p, const int32_t* src) {
  const int4* s = reinterpret_cast<const int4*>(src);
#pragma unroll
  for (int q = 0; q < PT / 4; ++q) {
    const int4 v = s[q];
    pt_limb(p, 4 * q) = v.x;
    pt_limb(p, 4 * q + 1) = v.y;
    pt_limb(p, 4 * q + 2) = v.z;
    pt_limb(p, 4 * q + 3) = v.w;
  }
}

__device__ __forceinline__ void pt_store(int32_t* dst, Pt& p) {
  int4* d = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int q = 0; q < PT / 4; ++q)
    d[q] = make_int4(pt_limb(p, 4 * q), pt_limb(p, 4 * q + 1),
                     pt_limb(p, 4 * q + 2), pt_limb(p, 4 * q + 3));
}

__device__ __forceinline__ void pt_identity(Pt& p) {
  p.X = fe_small(0);
  p.Y = fe_small(1);
  p.Z = fe_small(1);
  p.T = fe_small(0);
}

constexpr int PT32 = 4 * zc32::NW;     // words of one core-form point

// 16-byte loads and stores of a core-form point (128 bytes, 16-byte
// aligned).
__device__ __forceinline__ void pt32_load(zc32::Pt& p, const uint32_t* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int q = 0; q < PT32 / 4; ++q) {
    const uint4 v = s[q];
    zc32::pt_word(p, 4 * q) = v.x;
    zc32::pt_word(p, 4 * q + 1) = v.y;
    zc32::pt_word(p, 4 * q + 2) = v.z;
    zc32::pt_word(p, 4 * q + 3) = v.w;
  }
}

__device__ __forceinline__ void pt32_store(uint32_t* dst, zc32::Pt& p) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int q = 0; q < PT32 / 4; ++q)
    d[q] = make_uint4(zc32::pt_word(p, 4 * q), zc32::pt_word(p, 4 * q + 1),
                      zc32::pt_word(p, 4 * q + 2), zc32::pt_word(p, 4 * q + 3));
}

// Prep of k_bucket_accum: points [4][n][22] (signed lazy limbs, any value
// the limb engine makes) -> [n][4][8] Montgomery words, one thread per
// (point, coordinate).  Bound by its bytes: 88 read and 32 written per
// coordinate, one field multiply (to_mont).
__global__ void __launch_bounds__(ACCUM_BLOCK)
    k_to_field32(const int32_t* __restrict__ pts, uint32_t* __restrict__ out,
                 int n) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 4 * (size_t)n) return;
  const size_t i = idx >> 2;
  const int c = (int)(idx & 3);
  const int32_t* src = pts + ((size_t)c * n + i) * L;
  int32_t x[L];
#pragma unroll
  for (int k = 0; k < L; ++k) x[k] = src[k];
  const zc32::Fe v = zc32::to_mont(zc32::from_limbs(x));
  uint4* dst = reinterpret_cast<uint4*>(out + (i * 4 + c) * zc32::NW);
  dst[0] = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  dst[1] = make_uint4(v.w[4], v.w[5], v.w[6], v.w[7]);
}

// K7 -- replaces zerocaf_tpu/ops/pallas/msm_kernels.py:bucket_accum_all
// (_bucketall_kernel, _accum_one, _init_tables).  Signed-digit Pippenger
// bucket tables of every window in one launch.  The same kernel replaces
// K9 bucket_accum_k (_bucketk_kernel: one group of k windows), K11
// bucket_accum (_bucket_kernel: one window) and K12 bucket_accum2
// (_bucket2_kernel: a window pair): the TPU wrote one program per
// VMEM-sized output block, the card needs none of those limits.
//
// Thread (w, t), w < nw windows and t < lanes, owns window w's private
// table of lane t and folds the points i == t (mod lanes) into it, in
// order of i: for digit d = dig[w][i] != 0 it adds the point, with X and
// T negated when d < 0, to entry |d| (the entry is the first operand of
// padd_ext, as in _accum_one).  Every entry starts as the identity;
// digit 0 leaves the table untouched, so bucket 0 stays the identity.  The
// per-lane tables are then summed across lanes by K5
// (parallel/msm.py:_lane_reduce).
//
// Arithmetic: the 8 x 32-bit Montgomery core of field32.cuh.  The points
// arrive in its form from k_to_field32 ([n][4][8], 128 bytes a point).
// An entry is kept in the core's form in the first 128 bytes of its
// 352-byte slot of the output; when its loop ends the thread rewrites
// every slot as canonical 22 x 12-bit limbs, in place.  So the output is
// canonical ([0, p) limbs), and equal limb for limb to the plain version,
// which canonicalizes its 22 x 12 result.
//
// Layout: tbl [nw][nb][lanes][4][22] int32.  The digits are random, so
// neighbouring lanes almost never share an entry; contiguous entries use
// every byte of the sectors they touch.  The tables live in device memory
// and the hot entries in L2.  The thread indexes its bucket by the digit
// directly: MSM is not oblivious by design (docs/CONSTANT_TIME.md).
//
// One thread a (window, lane): K7 at 2^20 points (44 windows x 4096 lanes)
// has 180,224 threads, K9 (4 windows) 16,384.  Bound: nonzero digits x 10
// field multiplies; __launch_bounds__(128, 4) asks for at most 128
// registers, so 4 blocks of 128 threads share an SM.
__global__ void __launch_bounds__(ACCUM_BLOCK, ACCUM_MIN_BLOCKS)
    k_bucket_accum(const uint32_t* __restrict__ pts,
                   const int32_t* __restrict__ dig, int32_t* __restrict__ tbl,
                   int n, int nb, int nw, int lanes) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nw * lanes) return;
  const int w = idx / lanes;
  const int t = idx - w * lanes;
  // int32 offsets inside a window's table (nb * lanes * PT < 2^31, checked
  // by the wrapper): fewer registers than 64-bit ones
  const int stride = lanes * PT;                       // next bucket
  int32_t* mine = tbl + (size_t)w * nb * stride + t * PT;

  {
    zc32::Pt id;
    id.X = zc32::fe_zero();
    id.Y = zc32::fe_one();
    id.Z = zc32::fe_one();
    id.T = zc32::fe_zero();
    for (int b = 0; b < nb; ++b)
      pt32_store(reinterpret_cast<uint32_t*>(mine + b * stride), id);
  }

  const int32_t* dw = dig + (size_t)w * n;
  for (int i = t; i < n; i += lanes) {
    const int dv = dw[i];
    if (dv == 0) continue;
    zc32::Pt P, E;
    pt32_load(P, pts + (size_t)i * PT32);
    if (dv < 0) {
      P.X = zc32::fe_neg(P.X);
      P.T = zc32::fe_neg(P.T);
    }
    uint32_t* e = reinterpret_cast<uint32_t*>(mine + (dv < 0 ? -dv : dv) * stride);
    pt32_load(E, e);
    zc32::padd_ext(E, E, P, zc32::c_d32);
    pt32_store(e, E);
  }

  for (int b = 0; b < nb; ++b) {
    int32_t* slot = mine + b * stride;
    zc32::Pt E;
    pt32_load(E, reinterpret_cast<const uint32_t*>(slot));
    Pt out;
    zc32::to_limbs(E.X, out.X.v);
    zc32::to_limbs(E.Y, out.Y.v);
    zc32::to_limbs(E.Z, out.Z.v);
    zc32::to_limbs(E.T, out.T.v);
    pt_store(slot, out);
  }
}

// K8 -- replaces msm_kernels.py:combine_tables (_combine_kernel).  Bucket
// totals and Horner over windows in one block.  Thread w < nwin computes
// window w's total by the descending running sum (acc += S_b; tot += acc
// for b = nb-1 .. 1: 2(nb-1) additions) and leaves it in shared memory;
// then thread 0 runs Horner from the most significant window down: c
// doublings (T only on the last), one addition.  The TPU's lane roll has
// no counterpart: thread 0 reads the totals from shared memory.  Bound by
// the latency of the serial chain (about (nwin (c + 1) + 2(nb-1))
// dependent point operations), not by throughput.
//
// tbl: [nwin][nb][4][22] int32; out: [4][22].
__global__ void __launch_bounds__(COMBINE_THREADS)
    k_combine(const int32_t* __restrict__ tbl, int32_t* __restrict__ out,
              int nwin, int nb, int c) {
  __shared__ __align__(16) int32_t tot_s[COMBINE_THREADS * PT];
  const int w = threadIdx.x;
  if (w < nwin) {
    Pt acc, tot, e;
    pt_identity(acc);
    pt_identity(tot);
    for (int b = nb - 1; b >= 1; --b) {
      pt_load(e, tbl + ((size_t)w * nb + b) * PT);
      padd_ext(acc, acc, e);
      padd_ext(tot, tot, acc);
    }
    pt_store(tot_s + w * PT, tot);
  }
  __syncthreads();
  if (w != 0) return;
  Pt T, W;
  pt_identity(T);
  for (int s = nwin - 1; s >= 0; --s) {
    for (int j = 0; j < c; ++j) pdbl(T, j == c - 1);
    pt_load(W, tot_s + s * PT);
    padd_ext(T, T, W);
  }
  pt_store(out, T);
}

}  // namespace zc

// ---- launchers (plain C interface) ----------------------------------------

extern "C" {

int zc_to_field32(const int32_t* pts, uint32_t* out, int n, void* stream) {
  const size_t threads = 4 * (size_t)n;
  const unsigned blocks = (unsigned)((threads + zc::ACCUM_BLOCK - 1) /
                                     zc::ACCUM_BLOCK);
  zc::k_to_field32<<<blocks, zc::ACCUM_BLOCK, 0,
                     static_cast<cudaStream_t>(stream)>>>(pts, out, n);
  return static_cast<int>(cudaGetLastError());
}

int zc_bucket_accum(const uint32_t* pts, const int32_t* dig, int32_t* tbl,
                    int n, int nb, int nw, int lanes, void* stream) {
  const int threads = nw * lanes;
  const int blocks = (threads + zc::ACCUM_BLOCK - 1) / zc::ACCUM_BLOCK;
  zc::k_bucket_accum<<<blocks, zc::ACCUM_BLOCK, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      pts, dig, tbl, n, nb, nw, lanes);
  return static_cast<int>(cudaGetLastError());
}

int zc_combine(const int32_t* tbl, int32_t* out, int nwin, int nb, int c,
               void* stream) {
  if (nwin < 1 || nwin > zc::COMBINE_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  zc::k_combine<<<1, zc::COMBINE_THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(tbl, out, nwin, nb, c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
