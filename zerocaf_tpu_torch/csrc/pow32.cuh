// The per-lane body of k_pow (K2; csrc/field_kernels.cu) on the 8 x 32-bit
// core of field32.cuh, for either modulus: a^e for a public exponent e by
// width-4 digits, the same chain as the TPU kernel and the port's plain
// version (field_kernels.pow_tiled_ref): a table a^1..a^15, seed from the
// first digit, then per digit 4 squarings (fe_sq_sos) and, for a nonzero
// digit, one multiply by the entry at that digit.  a^0 (one) is never
// multiplied: a zero digit skips the multiply.
//
// The body is a template over the lane's table, an accessor with
//   Fe get(int k) const;  void put(int k, const Fe& v) const;
// for the entries k = 1..15.  The kernel's accessor addresses dynamic
// shared memory laid out [entry][word][thread], so a warp's reads of one
// word fall in 32 different banks; tests/test_torch_field32_host.py
// compiles this header for the host with an array per lane and holds the
// body against the oracle and the plain version.
//
// Constant time: the access pattern depends only on the public exponent.
// The entry read at a digit is indexed by that digit, and every branch
// (the zero digits' skipped multiplies) follows it; no load and no branch
// depends on a.

#pragma once

#include "field32.cuh"

namespace zc32 {

constexpr int POW_WIDTH = 4;
constexpr int POW_ENTRIES = 1 << POW_WIDTH;    // a^0 .. a^15

// a^e mod M, a and the result in Montgomery form.  digit(w), w < nwin,
// are e's width-4 digits, most significant first.
template <class M, class Dig, class Tbl>
__host__ __device__ __forceinline__ Fe pow_lane(const Fe& a, const Dig& digit,
                                                int nwin, const Tbl& tbl) {
  {
    tbl.put(1, a);
    Fe cur = a;
#pragma unroll 1
    for (int k = 2; k < POW_ENTRIES; ++k) {
      cur = fe_mul<M>(cur, a);
      tbl.put(k, cur);
    }
  }
  const int d0 = digit(0);
  Fe r = d0 ? tbl.get(d0) : fe_one<M>();
#pragma unroll 1
  for (int w = 1; w < nwin; ++w) {
#pragma unroll 1
    for (int s = 0; s < POW_WIDTH; ++s) r = fe_sq_sos<M>(r);
    const int d = digit(w);
    if (d) r = fe_mul<M>(r, tbl.get(d));
  }
  return r;
}

}  // namespace zc32
