// The comb's mixed addition (K6, k_comb in csrc/field_kernels.cu) on the
// 8 x 32-bit core of field32.cuh: Q += e for an extended Q and an
// affine-Niels table entry e = (y+x, y-x, 2dxy) in Montgomery form, 7
// multiplies, one thread:
//   PP = (Y+X)(y+x), MM = (Y-X)(y-x), TT = T 2dxy, Z2 = 2Z;
//   E = PP - MM, F = Z2 - TT, G = Z2 + TT, H = PP + MM;
//   X = E F, Y = G H, Z = F G, T = E H.
// These are the plain version's field values (field_kernels.py
// _madd_affine_block), term for term, so the kernel and its plain version
// agree on canonical limbs.  A signed digit's entry is -e = (y-x, y+x,
// -2dxy): comb_factors swaps the first two and negates the third.
//
// Constant time: every selection here is a mask.  The comb as a whole is
// not oblivious: the kernel loads the entry at the secret digit, as the
// reference and the JAX package do (docs/CONSTANT_TIME.md).

#pragma once

#include "field32.cuh"

namespace zc32 {

// The round-1 factors (y+x, y-x, 2dxy) of the entry e (its three
// coordinates), negated for a negative digit.
__host__ __device__ __forceinline__ void comb_factors(Fe (&f)[3],
                                                      const Fe (&e)[3],
                                                      bool neg) {
  f[0] = fe_pick(neg, e[1], e[0]);
  f[1] = fe_pick(neg, e[0], e[1]);
  f[2] = fe_pick(neg, fe_neg(e[2]), e[2]);
}

// Q += (f[0], f[1], f[2]) = (y+x, y-x, 2dxy), one thread.
__host__ __device__ __forceinline__ void madd_affine(Pt& Q, const Fe (&f)[3]) {
  const Fe PP = fe_mul(fe_add(Q.Y, Q.X), f[0]);
  const Fe MM = fe_mul(fe_sub(Q.Y, Q.X), f[1]);
  const Fe TT = fe_mul(Q.T, f[2]);
  const Fe Z2 = fe_add(Q.Z, Q.Z);
  const Fe E = fe_sub(PP, MM);
  const Fe F = fe_sub(Z2, TT);
  const Fe G = fe_add(Z2, TT);
  const Fe H = fe_add(PP, MM);
  Q.X = fe_mul(E, F);
  Q.Y = fe_mul(G, H);
  Q.Z = fe_mul(F, G);
  Q.T = fe_mul(E, H);
}

}  // namespace zc32
