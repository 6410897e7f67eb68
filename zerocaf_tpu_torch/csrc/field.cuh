// Device functions of the Hopper kernels: radix-2^12 x 22-limb int32 field
// arithmetic and the Edwards point formulas built from it.
//
// Replaces the block helpers of zerocaf_tpu/ops/pallas/field_kernels.py
// (_school_cols/_sq_cols, _carry3, _fold_once, _c1, _mul_const, _pdbl_block,
// _madd_block, _madd_affine_kernel's 7M addition, _padd_ext_block) with one
// thread per lane: a field element is
// 22 int32 limbs held by one thread, a product is 43 int32 columns.
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
//     square operands semi; one carry pass (fe_c1) at exactly the places the
//     reference has _c1.  These bounds keep every column inside int32, which
//     is what keeps signed overflow (undefined in C++) away.
//
// What bounds this on an H100: integer multiply-adds (about 1100 int32
// operations per field multiply, about 9,400 multiplies per lane for an ECDH)
// and the registers that 22-limb operands need.  The multiply and square are
// __noinline__ so that each kernel holds one copy of their unrolled bodies;
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

// Fold constants c, 2^252 == -c (mod m), of p (row 0) and r (row 1); the
// curve constants d and 2d.  Written by zc_init from the Python constants.
__constant__ int32_t c_fold[2][NC];
__constant__ int32_t c_d[L];
__constant__ int32_t c_d2[L];

struct Fe {
  int32_t v[L];
};

// Extended point (X, Y, Z, T), or a projective-Niels entry
// (Y+X, Y-X, Z, 2dT) in the same four slots.
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

// out = a^2 (mod m): a_i * 2a_j above the diagonal, a_i^2 on it -- the same
// column integers as fe_mul(a, a).  out may alias a.
__device__ __noinline__ void fe_sq(Fe& out, const Fe& a, int spec) {
  int32_t ra[L], r2[L], x[44];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    ra[k] = a.v[k];
    r2[k] = 2 * a.v[k];
  }
#pragma unroll
  for (int k = 0; k < 44; ++k) x[k] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    x[2 * i] += ra[i] * ra[i];
#pragma unroll
    for (int j = i + 1; j < L; ++j) x[i + j] += ra[i] * r2[j];
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

__device__ __forceinline__ Fe fe_neg(const Fe& a) {
  Fe r;
#pragma unroll
  for (int k = 0; k < L; ++k) r.v[k] = -a.v[k];
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

// r = mask ? a : r, for mask 0 or -1: a select without a branch.
__device__ __forceinline__ void fe_cmov(Fe& r, const Fe& a, int32_t mask) {
#pragma unroll
  for (int k = 0; k < L; ++k) r.v[k] = (a.v[k] & mask) | (r.v[k] & ~mask);
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

// Limb-major [22][n] element (per-lane tables): a warp's loads coalesce.
__device__ __forceinline__ void fe_load_t(Fe& r, const int32_t* base,
                                          size_t lane, size_t n) {
#pragma unroll
  for (int k = 0; k < L; ++k) r.v[k] = base[k * n + lane];
}

__device__ __forceinline__ void fe_store_t(int32_t* base, size_t lane,
                                           size_t n, const Fe& r) {
#pragma unroll
  for (int k = 0; k < L; ++k) base[k * n + lane] = r.v[k];
}

// ---------------------------------------------------------------------------
// Edwards point formulas over p (a = -1)
// ---------------------------------------------------------------------------

// dbl-2008-hwcd doubling, 4M+4S; T is computed only if with_t.
__device__ __forceinline__ void pdbl(Pt& Q, bool with_t) {
  Fe A, B, Zs, E;
  fe_sq(A, Q.X, 0);
  fe_sq(B, Q.Y, 0);
  fe_sq(Zs, Q.Z, 0);
  const Fe Cc = fe_add(Zs, Zs);        // 2-deep
  Fe S = fe_add(Q.X, Q.Y);
  fe_c1(S);                            // semi (square operand)
  fe_sq(E, S, 0);
  E = fe_sub(fe_sub(E, A), B);
  fe_c1(E);                            // 3-deep -> carry
  const Fe G = fe_sub(B, A);           // 2-deep
  Fe F = fe_sub(G, Cc);
  fe_c1(F);                            // 4-deep -> carry
  const Fe H = fe_sub(fe_neg(A), B);   // 2-deep
  fe_mul(Q.X, E, F, 0);
  fe_mul(Q.Y, G, H, 0);
  fe_mul(Q.Z, F, G, 0);
  if (with_t) fe_mul(Q.T, E, H, 0);
}

// Extended + projective-Niels addition, 8M; e = (Y+X, Y-X, Z, 2dT).
__device__ __forceinline__ void madd(Pt& Q, const Pt& e) {
  Fe PP, MM, TT, ZZ;
  fe_mul(PP, fe_add(Q.Y, Q.X), e.X, 0);
  fe_mul(MM, fe_sub(Q.Y, Q.X), e.Y, 0);
  fe_mul(TT, Q.T, e.T, 0);
  fe_mul(ZZ, Q.Z, e.Z, 0);
  const Fe ZZ2 = fe_add(ZZ, ZZ);
  Fe E = fe_sub(PP, MM);
  fe_c1(E);
  Fe F = fe_sub(ZZ2, TT);
  fe_c1(F);
  Fe G = fe_add(ZZ2, TT);
  fe_c1(G);
  const Fe H = fe_add(PP, MM);         // 2-deep
  fe_mul(Q.X, E, F, 0);
  fe_mul(Q.Y, G, H, 0);
  fe_mul(Q.Z, F, G, 0);
  fe_mul(Q.T, E, H, 0);
}

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

// Unified extended HWCD addition: R = P + Q (table build only).  R may
// alias P.
__device__ __forceinline__ void padd_ext(Pt& R, const Pt& P, const Pt& Q) {
  Fe A, B, Cc, Dd, S, D;
#pragma unroll
  for (int k = 0; k < L; ++k) D.v[k] = c_d[k];
  fe_mul(A, P.X, Q.X, 0);
  fe_mul(B, P.Y, Q.Y, 0);
  fe_mul(Cc, P.T, Q.T, 0);
  fe_mul(Cc, Cc, D, 0);
  fe_mul(Dd, P.Z, Q.Z, 0);
  fe_mul(S, fe_add(P.X, P.Y), fe_add(Q.X, Q.Y), 0);
  Fe E = fe_sub(fe_sub(S, A), B);
  fe_c1(E);
  Fe F = fe_sub(Dd, Cc);
  fe_c1(F);
  Fe G = fe_add(Dd, Cc);
  fe_c1(G);
  const Fe H = fe_add(A, B);
  fe_mul(R.X, E, F, 0);
  fe_mul(R.Y, G, H, 0);
  fe_mul(R.Z, F, G, 0);
  fe_mul(R.T, E, H, 0);
}

// Extended point -> projective-Niels entry (Y+X, Y-X, Z, 2dT).
__device__ __forceinline__ void to_niels(Pt& e, const Pt& P) {
  Fe D2;
#pragma unroll
  for (int k = 0; k < L; ++k) D2.v[k] = c_d2[k];
  e.X = fe_add(P.Y, P.X);
  fe_c1(e.X);
  e.Y = fe_sub(P.Y, P.X);
  fe_c1(e.Y);
  e.Z = P.Z;
  fe_mul(e.T, P.T, D2, 0);
}

}  // namespace zc
