// Hopper kernels of Pippenger MSM: K7 (bucket accumulation for all window
// groups; K9, K11 and K12 launch it too) with its prep kernel, and K8
// (window combine; its point operations in quad32.cuh), on the 8 x 32-bit
// core of field32.cuh, with a plain C launcher each (bound with ctypes by
// zerocaf_tpu_torch/ops/kernels/build.py).  Every launcher enqueues on the
// stream it is given and returns cudaGetLastError().  The kernels write
// canonical limbs, equal to their plain PyTorch versions'
// (zerocaf_tpu_torch/ops/kernels/msm_kernels.py) after canonicalization.

#include <cuda_runtime.h>

#include "field32.cuh"
#include "init.cuh"
#include "quad32.cuh"

namespace zc {

constexpr int L = zc32::NL;            // limbs of a 22 x 12-bit element
constexpr int ACCUM_BLOCK = 128;
constexpr int ACCUM_MIN_BLOCKS = 4;    // k_bucket_accum's blocks per SM
constexpr int MAX_COMBINE_WINDOWS = 128;   // k_combine: a quad a window
constexpr int PT = 4 * L;              // int32 of one extended point

// 16-byte stores of a contiguous point's 88 limbs (X, Y, Z, T; 352 bytes,
// 16-byte aligned: every table entry starts at a multiple of 352 bytes).
__device__ __forceinline__ void pt_store(int32_t* dst, const int32_t (&p)[PT]) {
  int4* d = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int q = 0; q < PT / 4; ++q)
    d[q] = make_int4(p[4 * q], p[4 * q + 1], p[4 * q + 2], p[4 * q + 3]);
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
    int32_t out[PT];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      int32_t limbs[L];
      zc32::to_limbs(zc32::coord(E, c), limbs);
#pragma unroll
      for (int k = 0; k < L; ++k) out[c * L + k] = limbs[k];
    }
    pt_store(slot, out);
  }
}

// K8 -- replaces msm_kernels.py:combine_tables (_combine_kernel).  Bucket
// totals and Horner over windows in one block, on the 8 x 32-bit core,
// each point operation shared by a quad of four threads (quad32.cuh).
//
// Entry: every thread converts a share of the bucket sums ([nwin][nb][4]
// [22] limbs, any values the limb engine makes) into the core's form in
// the scratch buffer `cv` ([nwin][nb][4][8] words), T as d T, the factor
// padd_ext's C takes (one multiply: from_limbs value times d R^2).  Then
// quad w < nwin runs window w's descending running sum (acc += S_b; tot +=
// acc for b = nb-1 .. 1), d T_acc taking one more round before each tot
// addition, and leaves its total, T as d T, in shared memory.  Quad 0 then
// runs Horner from the most significant window down: c doublings, one
// addition of the window's total; then `tail` more doublings (the
// window-sharded combine's rank weight, parallel/msm.py), and writes
// canonical limbs.  The TPU's lane roll has no counterpart.
//
// Bound by the latency of the serial chain, not by throughput: (nb - 1)
// running-sum steps of 5 multiply rounds (acc, d T, tot), then nwin (c +
// 1) point operations of 2 rounds and tail doublings, each round one
// dependent field multiply (its latency is chip_smoke.py's zc_mul_chain
// probe) plus the quad's shuffles and additions.  One thread a point takes
// 8-9 dependent multiplies an operation: 2.1 ms at nwin 42, nb 33, c 6,
// against the quads' 0.78 (on an H100, chip_variants.py, PERF.md).  The
// multiply stays rolled: unrolled, K8 took 1.07 ms.
//
// tbl: [nwin][nb][4][22] int32; cv: scratch of nwin * nb * 32 words; out:
// [4][22].  The block is 4 nwin threads.
__global__ void __launch_bounds__(4 * MAX_COMBINE_WINDOWS)
    k_combine(const int32_t* __restrict__ tbl, uint32_t* __restrict__ cv,
              int32_t* __restrict__ out, int nwin, int nb, int c, int tail) {
  __shared__ zc32::Fe tot_s[MAX_COMBINE_WINDOWS][4];
  const int j = threadIdx.x & 3;                      // role: X, Y, Z, T
  const int w = threadIdx.x >> 2;                     // window
  const unsigned mask = 0xfu << (threadIdx.x & 28);   // the quad's lanes
  const auto x = [&](const zc32::Fe& v, int s) {
    zc32::Fe r;
#pragma unroll
    for (int i = 0; i < zc32::NW; ++i) r.w[i] = __shfl_sync(mask, v.w[i], s, 4);
    return r;
  };
  zc32::Fe r2, one;
#pragma unroll
  for (int i = 0; i < zc32::NW; ++i) {
    r2.w[i] = zc32::ModP::r2(i);
    one.w[i] = zc32::ModP::one(i);
  }
  const zc32::Fe d = zc32::c_d32;
  const zc32::Fe dr2 = zc32::fe_mul(d, r2);           // d R^2

  // the bucket sums 1..nb-1 of every window into the core's form
  const int per_w = (nb - 1) * 4;
  for (int e = threadIdx.x; e < nwin * per_w; e += blockDim.x) {
    const int ww = e / per_w, rest = e - ww * per_w;
    const size_t slot = ((size_t)ww * nb + 1 + rest / 4) * 4 + (rest & 3);
    int32_t v[L];
#pragma unroll
    for (int k = 0; k < L; ++k) v[k] = tbl[slot * L + k];
    const zc32::Fe f = zc32::fe_mul(zc32::from_limbs(v),
                                    zc32::fe_pick((rest & 3) == 3, dr2, r2));
    uint4* dst = reinterpret_cast<uint4*>(cv + slot * zc32::NW);
    dst[0] = make_uint4(f.w[0], f.w[1], f.w[2], f.w[3]);
    dst[1] = make_uint4(f.w[4], f.w[5], f.w[6], f.w[7]);
  }
  __syncthreads();

  const auto coord = [&](const uint32_t* pt, int k) {   // coordinate k
    const uint4* s = reinterpret_cast<const uint4*>(pt + k * zc32::NW);
    const uint4 lo = s[0], hi = s[1];
    return zc32::Fe{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
  };
  const zc32::Fe id = zc32::fe_pick(j == 1 || j == 2, one, zc32::fe_zero());
  zc32::Fe acc = id, tot = id;
  for (int b = nb - 1; b >= 1; --b) {
    const uint32_t* S = cv + ((size_t)w * nb + b) * 4 * zc32::NW;
    zc32::quad_padd(acc, zc32::quad_operand(coord(S, zc32::quad_add_a(j)),
                                            coord(S, zc32::quad_add_b(j)), j),
                    j, x);
    zc32::quad_padd(tot, zc32::quad_held_operand(acc, j, x, d, one), j, x);
  }
  tot_s[w][j] = zc32::fe_mul(tot, zc32::fe_pick(j == 3, d, one));
  __syncthreads();
  if (threadIdx.x >= 4) return;

  zc32::Fe T = id;
  for (int s = nwin - 1; s >= 0; --s) {
    for (int i = 0; i < c; ++i) zc32::quad_pdbl(T, j, x);
    zc32::quad_padd(T, zc32::quad_operand(tot_s[s][zc32::quad_add_a(j)],
                                          tot_s[s][zc32::quad_add_b(j)], j),
                    j, x);
  }
  for (int i = 0; i < tail; ++i) zc32::quad_pdbl(T, j, x);
  int32_t limbs[L];
  zc32::to_limbs(T, limbs);
#pragma unroll
  for (int k = 0; k < L; ++k) out[j * L + k] = limbs[k];
}

// The latency of one dependent multiply of the core, the unit of K8's
// chain bound (chip_smoke.py): one thread runs `iters` multiplies, each of
// the last one's product.  x: the factors a and b (8 words each); a is
// overwritten with a b^iters R^-iters.
__global__ void k_mul_chain(uint32_t* x, int iters) {
  zc32::Fe a, b;
#pragma unroll
  for (int i = 0; i < zc32::NW; ++i) {
    a.w[i] = x[i];
    b.w[i] = x[zc32::NW + i];
  }
  for (int k = 0; k < iters; ++k) a = zc32::fe_mul(a, b);
#pragma unroll
  for (int i = 0; i < zc32::NW; ++i) x[i] = a.w[i];
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

// cv: scratch of nwin * nb * 32 words (the bucket sums in the core's form).
int zc_combine(const int32_t* tbl, int32_t* cv, int32_t* out, int nwin, int nb,
               int c, int tail, void* stream) {
  if (nwin < 1 || nwin > zc::MAX_COMBINE_WINDOWS)
    return static_cast<int>(cudaErrorInvalidValue);
  zc::k_combine<<<1, 4 * nwin, 0, static_cast<cudaStream_t>(stream)>>>(
      tbl, reinterpret_cast<uint32_t*>(cv), out, nwin, nb, c, tail);
  return static_cast<int>(cudaGetLastError());
}

int zc_mul_chain(uint32_t* x, int iters, void* stream) {
  zc::k_mul_chain<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(x, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
