// Point operations of k_combine (K8; csrc/msm_kernels.cu) shared by four
// threads, a quad, on the 8 x 32-bit core of field32.cuh: the 4-way form
// of the extended formulas (Hisil, Wong, Carter, Dawson 2008, section 4).
//
// Role j (0..3) of the quad holds coordinate j (X, Y, Z, T) of the point,
// in Montgomery form.  Each operation is two rounds of one field multiply
// a role, with the operands moved between the roles by x(v, s), which
// returns role s's v (__shfl_sync on the card; an array read between
// barriers on the host, tests/test_torch_field32_host.py).  Every role
// calls x the same number of times, in the same order.  So a point
// operation's critical path is two dependent multiplies, not the eight or
// nine of one thread.
//
// The results are field32.cuh's padd_ext and pdbl field value for field
// value (not merely the same projective point), so the kernel and its
// plain version agree on canonical limbs:
//   padd: round 1 A' = (Y1-X1)(Y2-X2), B' = (Y1+X1)(Y2+X2), C = T1 (d T2),
//         D = Z1 Z2; E = (B' - A') / 2 = X1 Y2 + Y1 X2 and H = (B' + A') /
//         2 = X1 X2 + Y1 Y2 are padd_ext's E and H, F = D - C, G = D + C;
//         round 2 X3 = E F, Y3 = G H, Z3 = F G, T3 = E H.
//   pdbl: round 1 the squares (X+Y)^2, X^2, Z^2, Y^2, by fe_sq_sos; E, F,
//         G, H as pdbl's; round 2 as padd's.  T3 is always computed (the
//         fourth role would idle); pdbl without T leaves a T that no later
//         formula reads before a doubling with T overwrites it.
// After round 1 the roles hold E, H, F, G; round 2 reads two of them.
//
// Constant time: the roles' selections are masks; no branch depends on a
// value.

#pragma once

#include "field32.cuh"

namespace zc32 {

// The roles whose coordinates role j combines into its round-1 operand of
// an addition, a and b: X and Y for roles 0 and 1, T for role 2, Z for
// role 3 (b = a there).
__host__ __device__ __forceinline__ int quad_add_a(int j) {
  return j < 2 ? 0 : 5 - j;
}
__host__ __device__ __forceinline__ int quad_add_b(int j) {
  return j < 2 ? 1 : 5 - j;
}

// Role j's round-1 operand of an addition from a and b (coordinates
// quad_add_a(j) and quad_add_b(j) of one operand): Y - X, Y + X, T, Z.
__host__ __device__ __forceinline__ Fe quad_operand(const Fe& a, const Fe& b,
                                                    int j) {
  return fe_pick(j == 0, fe_sub(b, a), fe_pick(j == 1, fe_add(b, a), a));
}

// Role j's round-1 operand of an addition of a point Q that the quad
// holds (role j its coordinate j): for T2, d T2, one more multiply round
// (one is the Montgomery one).
template <class X>
__host__ __device__ __forceinline__ Fe quad_held_operand(const Fe& q, int j,
                                                         const X& x,
                                                         const Fe& d,
                                                         const Fe& one) {
  const Fe o = quad_operand(x(q, quad_add_a(j)), x(q, quad_add_b(j)), j);
  return fe_mul(o, fe_pick(j == 2, d, one));
}

// Round 2: role j's coordinate E F, G H, F G or E H, from the roles'
// E, H, F, G.
template <class X>
__host__ __device__ __forceinline__ Fe quad_round2(const Fe& efgh, int j,
                                                   const X& x) {
  const Fe l = x(efgh, j == 1 ? 3 : j == 2 ? 2 : 0);
  const Fe r = x(efgh, j == 0 ? 2 : j == 2 ? 3 : 1);
  return fe_mul(l, r);
}

// v += Q (padd_ext): rop is role j's round-1 operand of Q, quad_operand of
// Q's coordinates quad_add_a(j) and quad_add_b(j), with d T2 for T2.
template <class X>
__host__ __device__ __forceinline__ void quad_padd(Fe& v, const Fe& rop,
                                                   int j, const X& x) {
  const Fe a = x(v, quad_add_a(j));
  const Fe b = x(v, quad_add_b(j));
  const Fe p = fe_mul(quad_operand(a, b, j), rop);   // A', B', C, D
  const Fe lo = x(p, j & 2), hi = x(p, (j & 2) + 1);
  const Fe s = fe_pick(j & 1, fe_add(hi, lo), fe_sub(hi, lo));
  v = quad_round2(fe_pick(j < 2, fe_half(s), s), j, x);
}

// v = 2 v (pdbl, with T).
template <class X>
__host__ __device__ __forceinline__ void quad_pdbl(Fe& v, int j, const X& x) {
  const Fe a = x(v, j == 2 ? 2 : j == 3 ? 1 : 0);
  const Fe b = x(v, j == 2 ? 2 : j == 1 ? 0 : 1);
  const Fe op = fe_pick(j == 0, fe_add(a, b), a);
  const Fe sq = fe_sq_sos(op);                           // (X+Y)^2, A, Zs, B
  const Fe A = x(sq, 1), B = x(sq, 3);
  const Fe G = fe_sub(B, A);
  const Fe e = fe_pick(j == 0, fe_sub(fe_sub(sq, A), B),
               fe_pick(j == 1, fe_neg(fe_add(A, B)),
               fe_pick(j == 2, fe_sub(G, fe_add(sq, sq)), G)));
  v = quad_round2(e, j, x);
}

}  // namespace zc32
