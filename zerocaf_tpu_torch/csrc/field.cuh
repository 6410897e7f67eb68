// Device functions of k_mul (K1) and k_comb (K6): radix-2^12 x 22-limb
// int32 field arithmetic and the comb's mixed addition built from it (the
// other kernels compute on the 8 x 32-bit core of field32.cuh).
//
// Replaces the block helpers of zerocaf_tpu/ops/pallas/field_kernels.py
// (_school_cols, _carry3, _fold_once, _c1, _mul_const, _madd_affine_kernel's
// 7M addition) with one thread per lane: a field element is 22 int32 limbs
// held by one thread, a product is 43 int32 columns.
//
// The limb algebra is the reference's, step for step, so the kernels agree
// limb for limb with their plain PyTorch versions
// (zerocaf_tpu_torch/ops/kernels/field_kernels.py):
//   * carry pass: limbs 0..n-2 split into (x & 4095, x >> 12), the carry moves
//     one limb up, the top limb is kept whole (it carries the sign);
//   * reduction: 43 columns -> 2 carry passes at width 44 -> fold 35 -> fold
//     26 -> fold 22, each fold value(L) - c * value(H) at limb 21 followed by
//     2 carry passes;
//   * laziness: semi limbs < 2^12.1; multiply operands at most one add deep;
//     one carry pass (fe_c1) at exactly the places the reference has _c1.
//     These bounds keep every column inside int32, which is what keeps
//     signed overflow (undefined in C++) away.
//
// What bounds this on an H100: integer multiply-adds (about 1100 int32
// operations per field multiply, about 9,400 multiplies per lane for an ECDH)
// and the registers that 22-limb operands need.  The multiply is
// __noinline__ so that each kernel holds one copy of its unrolled body;
// their operands pass through the thread's local memory (L1), which costs
// some speed and keeps the build to seconds.  A 64-bit-limb representation
// using the 32x32->64-bit multiply is later work, measured against this one.

#pragma once

#include <stdint.h>

namespace zc {

constexpr int L = 22;                  // limbs per element
constexpr int W = 12;                  // radix bits
constexpr int32_t MASK = (1 << W) - 1;
constexpr int FL = 21;                 // fold limb: bit 252
constexpr int NC = 12;                 // limbs of a fold constant (< 2^133)

// Fold constants c, 2^252 == -c (mod m), of p (row 0) and r (row 1).
// Written by zc_init from the Python constants.
__constant__ int32_t c_fold[2][NC];

struct Fe {
  int32_t v[L];
};

// Extended point (X, Y, Z, T).
struct Pt {
  Fe X, Y, Z, T;
};

// One keep-top carry pass.  Iterating downwards reads each carry from the
// limb below before that limb is rewritten, as the data-parallel form does.
template <int N>
__device__ __forceinline__ void carry_pass(int32_t (&x)[N]) {
#pragma unroll
  for (int i = N - 1; i >= 1; --i) {
    const int32_t c = x[i - 1] >> W;
    x[i] = (i == N - 1 ? x[i] : (x[i] & MASK)) + c;
  }
  x[0] &= MASK;
}

// Width of a fold's output for an input of width N.
template <int N>
struct FoldWidth {
  static constexpr int ND = N - FL + NC - 1;           // columns of c * H
  static constexpr int M = (ND > FL ? ND : FL) + 1;
};

// y = carry2(L - c * H) with L = x[0..20], H = x[21..N-1].
template <int N>
__device__ __forceinline__ void fold_once(const int32_t (&x)[N],
                                          int32_t (&y)[FoldWidth<N>::M],
                                          int spec) {
  constexpr int M = FoldWidth<N>::M;
  constexpr int NH = N - FL;
#pragma unroll
  for (int k = 0; k < M; ++k) y[k] = k < FL ? x[k] : 0;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int32_t ci = c_fold[spec][i];
#pragma unroll
    for (int j = 0; j < NH; ++j) y[i + j] -= ci * x[FL + j];
  }
  carry_pass(y);
  carry_pass(y);
}

// 43 product columns (x[43] == 0) -> semi-reduced 22 limbs.
__device__ __forceinline__ void reduce_cols(int32_t (&x)[44], Fe& out,
                                            int spec) {
  carry_pass(x);
  carry_pass(x);
  int32_t y1[FoldWidth<44>::M];
  fold_once(x, y1, spec);
  int32_t y2[FoldWidth<FoldWidth<44>::M>::M];
  fold_once(y1, y2, spec);
  int32_t y3[FoldWidth<FoldWidth<FoldWidth<44>::M>::M>::M];
  static_assert(sizeof(y3) == L * sizeof(int32_t), "fold walk must end at 22");
  fold_once(y2, y3, spec);
#pragma unroll
  for (int k = 0; k < L; ++k) out.v[k] = y3[k];
}

// out = a * b (mod m).  out may alias a or b.
__device__ __noinline__ void fe_mul(Fe& out, const Fe& a, const Fe& b,
                                    int spec) {
  int32_t ra[L], rb[L], x[44];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    ra[k] = a.v[k];
    rb[k] = b.v[k];
  }
#pragma unroll
  for (int k = 0; k < 44; ++k) x[k] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
#pragma unroll
    for (int j = 0; j < L; ++j) x[i + j] += ra[i] * rb[j];
  }
  reduce_cols(x, out, spec);
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int k = 0; k < L; ++k) r.v[k] = a.v[k] + b.v[k];
  return r;
}

__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int k = 0; k < L; ++k) r.v[k] = a.v[k] - b.v[k];
  return r;
}

__device__ __forceinline__ void fe_c1(Fe& x) { carry_pass(x.v); }

__device__ __forceinline__ Fe fe_small(int32_t v) {
  Fe r;
#pragma unroll
  for (int k = 0; k < L; ++k) r.v[k] = 0;
  r.v[0] = v;
  return r;
}

// Lane-major [n][22] element of lane `lane`.
__device__ __forceinline__ void fe_load(Fe& r, const int32_t* base,
                                        size_t lane) {
#pragma unroll
  for (int k = 0; k < L; ++k) r.v[k] = base[lane * L + k];
}

__device__ __forceinline__ void fe_store(int32_t* base, size_t lane,
                                         const Fe& r) {
#pragma unroll
  for (int k = 0; k < L; ++k) base[lane * L + k] = r.v[k];
}

// ---------------------------------------------------------------------------
// The comb's mixed addition over p (a = -1)
// ---------------------------------------------------------------------------

// Extended + affine-Niels addition, 7M: (ep, em, et) = (y+x, y-x, 2dxy)
// with canonical limbs, et possibly negated (a signed comb digit).  Z2 is
// 2Z in place of madd's Z * entry.Z.
__device__ __forceinline__ void madd_affine(Pt& Q, const Fe& ep, const Fe& em,
                                            const Fe& et) {
  Fe PP, MM, TT;
  fe_mul(PP, fe_add(Q.Y, Q.X), ep, 0);
  fe_mul(MM, fe_sub(Q.Y, Q.X), em, 0);
  fe_mul(TT, Q.T, et, 0);
  const Fe Z2 = fe_add(Q.Z, Q.Z);      // 2-deep
  Fe E = fe_sub(PP, MM);
  fe_c1(E);
  Fe F = fe_sub(Z2, TT);
  fe_c1(F);
  Fe G = fe_add(Z2, TT);
  fe_c1(G);
  const Fe H = fe_add(PP, MM);         // 2-deep
  fe_mul(Q.X, E, F, 0);
  fe_mul(Q.Y, G, H, 0);
  fe_mul(Q.Z, F, G, 0);
  fe_mul(Q.T, E, H, 0);
}

}  // namespace zc
