// Hopper kernels of Pippenger MSM: K7 (bucket accumulation for all window
// groups; K9, K11 and K12 launch it too) and K8 (window combine), with a
// plain C launcher each (bound with ctypes by zerocaf_tpu_torch/ops/kernels/build.py).
// Every launcher enqueues on the stream it is given and returns
// cudaGetLastError().  The point formulas are those of field.cuh, so each
// kernel agrees limb for limb with its plain PyTorch version
// (zerocaf_tpu_torch/ops/kernels/msm_kernels.py).

#include <cuda_runtime.h>

#include "field.cuh"
#include "init.cuh"

namespace zc {

constexpr int ACCUM_BLOCK = 128;
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

// K7 -- replaces zerocaf_tpu/ops/pallas/msm_kernels.py:bucket_accum_all
// (_bucketall_kernel, _accum_one, _init_tables).  Signed-digit Pippenger
// bucket tables for all window groups in one launch.  The same kernel
// replaces K9 bucket_accum_k (_bucketk_kernel: ngrp = 1), K11 bucket_accum
// (_bucket_kernel: ngrp = k = 1) and K12 bucket_accum2 (_bucket2_kernel:
// ngrp = 1, k = 2): the TPU wrote one program per VMEM-sized output block,
// the card needs none of those limits.  At ngrp = 1 a launch has only
// `lanes` threads (4096 at 2^20 points: 32 blocks on 132 SMs), so K11 and
// K12 leave most of the card idle, as their TPU forms left the grid serial.
//
// Thread (g, t), g < ngrp and t < lanes, owns one private table per window
// h < k of group g and folds the points i == t (mod lanes) into them, in
// order of i: for digit d = dig[g][h][i] != 0 it adds the point, with X and
// T negated by plain limb negation when d < 0, to entry |d| (the entry is
// the first operand of padd_ext, as in _accum_one).  Every entry starts as
// the identity (0, 1, 1, 0); digit 0 leaves the table untouched, so bucket
// 0 is never read and stays the identity.  The per-lane tables are then
// summed across lanes by K5 (parallel/msm.py:_lane_reduce).
//
// Layout: tbl [ngrp][k][nb][lanes][4][22] int32 -- a thread's entry is 352
// contiguous bytes, read and written with 16-byte accesses.  The digits are
// random, so neighbouring lanes almost never share an entry, and an entry
// with the lane axis innermost would cost a 32-byte sector for every 4-byte
// limb; contiguous entries use every byte of the sectors they touch.  The
// TPU kept each lane's 12.7 KB table in VMEM; here the tables live in
// device memory (at 2^20 points, c = 6, 4096 lanes: 2.09 GB) and the hot
// entries in L2.
//
// The thread indexes its bucket by the digit directly: the TPU read every
// entry only because it has no gather.  MSM is not oblivious by design
// (docs/CONSTANT_TIME.md): its points and scalars are public.
//
// Bound: nonzero digits x 10 field multiplies (about 9,900 integer
// multiply-adds each); the bytes (points, digits, tables) are far below.
// Register pressure of padd_ext is what limits occupancy.
__global__ void __launch_bounds__(ACCUM_BLOCK)
    k_bucket_accum(const int32_t* __restrict__ pts,
                   const int32_t* __restrict__ dig, int32_t* __restrict__ tbl,
                   int n, int nb, int k, int ngrp, int lanes) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ngrp * lanes) return;
  const int g = idx / lanes;
  const int t = idx - g * lanes;
  const size_t nn = n;
  const size_t plane = L * nn;
  const size_t entry_stride = (size_t)lanes * PT;      // next bucket
  int32_t* mine = tbl + (size_t)g * k * nb * entry_stride + (size_t)t * PT;

  {
    Pt id;
    pt_identity(id);
    for (int e = 0; e < k * nb; ++e) pt_store(mine + e * entry_stride, id);
  }

  for (size_t i = t; i < nn; i += lanes) {
    for (int h = 0; h < k; ++h) {
      const int d = dig[((size_t)g * k + h) * nn + i];
      if (d == 0) continue;
      Pt P, E;
      fe_load(P.X, pts, i);
      fe_load(P.Y, pts + plane, i);
      fe_load(P.Z, pts + 2 * plane, i);
      fe_load(P.T, pts + 3 * plane, i);
      if (d < 0) {
        P.X = fe_neg(P.X);
        P.T = fe_neg(P.T);
      }
      int32_t* e = mine + ((size_t)h * nb + (d < 0 ? -d : d)) * entry_stride;
      pt_load(E, e);
      padd_ext(E, E, P);
      pt_store(e, E);
    }
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

int zc_bucket_accum(const int32_t* pts, const int32_t* dig, int32_t* tbl,
                    int n, int nb, int k, int ngrp, int lanes, void* stream) {
  const int threads = ngrp * lanes;
  const int blocks = (threads + zc::ACCUM_BLOCK - 1) / zc::ACCUM_BLOCK;
  zc::k_bucket_accum<<<blocks, zc::ACCUM_BLOCK, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      pts, dig, tbl, n, nb, k, ngrp, lanes);
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
