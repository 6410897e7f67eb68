// The per-lane body of k_canonical (csrc/field_kernels.cu): the limb
// engine's canonicalization at the observation boundary, on the 22 x 12-bit
// limbs themselves, and the five things an observer reads from it
// (canonical limbs, little-endian bytes, zero, a compare with a constant,
// equality of two operands).
//
// It computes exactly what ops/limb.py's canonical_plain computes for the
// i32x22 specs, step for step on int32 limbs: the exact carry; 64 m added
// where the value is negative; the carry again; the fold at bit 252 (p) or
// 249 (r); one conditional add of m; the final carry.  The byte, zero,
// compare and equality reads are those of limbs_to_bytes, is_zero,
// geq_const and eq.  So the kernel equals its plain version bit for bit.
// No Montgomery core here: canonicalization is carries and one short
// product, and the boundary's own limbs are what the observer reads.
//
// Constant time: no branch and no memory index depends on a limb value.
// The conditional adds are masks (the sign word of the top limb), the
// compare and equality fold every limb into flags with bit operations, and
// every loop has a static trip count.
//
// Every function is __host__ __device__ __forceinline__ plain C++, so
// tests/test_torch_field32_host.py compiles this header for the host with
// g++ and holds each mode against the plain version and Python integers.

#pragma once

#include <stdint.h>

#include "field32.cuh"

namespace zc32 {

constexpr int32_t LMASK = (1 << LW) - 1;
constexpr int NFOLD = 12;              // limbs of a fold constant

// What k_canonical writes (the wrapper's mode names in brackets).
enum CanonMode {
  CANON_LIMBS = 0,                     // canonical limbs [n][22] ("limbs")
  CANON_BYTES = 1,                     // 32 little-endian bytes ("bytes")
  CANON_ZERO = 2,                      // value == 0, one byte ("zero")
  CANON_GEQ = 3,                       // value >= a bound, one byte ("geq")
  CANON_EQ = 4,                        // a == b, one byte ("eq")
};

// A modulus m = 2^K + c in 22 x 12-bit limbs: m, 64 m (> 2^255, added to a
// negative value) and c (< 2^133, NFOLD limbs); bit K sits at bit FB of
// limb FL (K = 12 FL + FB).
struct LimbP {                         // p = 2^252 + c
  static constexpr int FL = 21, FB = 0;
  static __host__ __device__ __forceinline__ int32_t m(int i) {
    constexpr int32_t v[NL] = {1005, 3933, 2652, 1585, 2066, 3429, 1948, 2607,
                               2526, 3567, 20, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1};
    return v[i];
  }
  static __host__ __device__ __forceinline__ int32_t m64(int i) {
    constexpr int32_t v[NL] = {2880, 1871, 1853, 3177, 1176, 2400, 1845, 3038,
                               1960, 3047, 1335, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 64};
    return v[i];
  }
  static __host__ __device__ __forceinline__ int32_t c(int i) {
    constexpr int32_t v[NFOLD] = {1005, 3933, 2652, 1585, 2066, 3429,
                                  1948, 2607, 2526, 3567, 20, 0};
    return v[i];
  }
};

struct LimbR {                         // r = 2^249 + c
  static constexpr int FL = 20, FB = 9;
  static __host__ __device__ __forceinline__ int32_t m(int i) {
    constexpr int32_t v[NL] = {2147, 1532, 3957, 54, 2740, 2358, 4053, 2082,
                               1869, 3692, 10, 0, 0, 0, 0, 0, 0, 0, 0, 0, 512, 0};
    return v[i];
  }
  static __host__ __device__ __forceinline__ int32_t m64(int i) {
    constexpr int32_t v[NL] = {2240, 3873, 3415, 3517, 3328, 3498, 1380, 2239,
                               864, 2845, 697, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 8};
    return v[i];
  }
  static __host__ __device__ __forceinline__ int32_t c(int i) {
    constexpr int32_t v[NFOLD] = {2147, 1532, 3957, 54, 2740, 2358,
                                  4053, 2082, 1869, 3692, 10, 0};
    return v[i];
  }
};

// Exact sequential carry: limbs 0..20 land in [0, 4096), the top limb keeps
// the signed rest (limb.carry_exact; >> is arithmetic).
__host__ __device__ __forceinline__ void carry_exact(int32_t (&x)[NL]) {
  int32_t c = 0;
#pragma unroll
  for (int i = 0; i < NL - 1; ++i) {
    const int32_t t = x[i] + c;
    x[i] = t & LMASK;
    c = t >> LW;
  }
  x[NL - 1] += c;
}

// x += v where the top limb is negative: the sign word as a mask.
template <class F>
__host__ __device__ __forceinline__ void add_if_negative(int32_t (&x)[NL],
                                                         F v) {
  const int32_t neg = x[NL - 1] >> 31;
#pragma unroll
  for (int i = 0; i < NL; ++i) x[i] += v(i) & neg;
}

// Any value in (-2^255, 2^255) as int32 limbs -> its canonical limbs mod
// K's modulus, in place (limb.canonical_plain).
template <class K>
__host__ __device__ __forceinline__ void canon_limbs(int32_t (&x)[NL]) {
  carry_exact(x);
  add_if_negative(x, [](int i) { return K::m64(i); });
  carry_exact(x);                      // non-negative, < 2^259
  // low + h 2^K == low - h c (mod m), h < 2^10
  int32_t h;
  if constexpr (K::FB == 0) {
    h = x[K::FL];
    x[K::FL] = 0;
  } else {
    h = (x[K::FL] >> K::FB) + (x[K::FL + 1] << (LW - K::FB));
    x[K::FL] &= (1 << K::FB) - 1;
  }
#pragma unroll
  for (int i = K::FL + 1; i < NL; ++i) x[i] = 0;
#pragma unroll
  for (int j = 0; j < NFOLD; ++j) x[j] -= h * K::c(j);
  carry_exact(x);                      // in (-m, m)
  add_if_negative(x, [](int i) { return K::m(i); });
  carry_exact(x);
}

// Nibble q (0..65) of canonical limbs, as limb.limbs_to_bytes reads them:
// a limb is three nibbles, the top one unmasked.
__host__ __device__ __forceinline__ int32_t nibble(const int32_t (&x)[NL],
                                                   int q) {
  const int32_t v = x[q / 3];
  return q % 3 == 0 ? v & 15 : q % 3 == 1 ? (v >> 4) & 15 : v >> 8;
}

// The 32 little-endian bytes of canonical limbs as 8 words.
__host__ __device__ __forceinline__ void canon_bytes(const int32_t (&x)[NL],
                                                     uint32_t (&w)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = 4 * i + j;
      const uint32_t byte =
          (uint32_t)(nibble(x, 2 * b) + (nibble(x, 2 * b + 1) << 4)) & 0xFFu;
      word |= byte << (8 * j);
    }
    w[i] = word;
  }
}

// 1 where every limb is zero.
__host__ __device__ __forceinline__ int32_t limbs_zero(const int32_t (&x)[NL]) {
  int32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) acc |= x[i];
  return acc == 0;
}

// 1 where x >= bound (limb.geq_const): lexicographic from the top limb,
// every limb folded in; equal counts as >=.  `bound(i)` is limb i.
template <class B>
__host__ __device__ __forceinline__ int32_t limbs_geq(const int32_t (&x)[NL],
                                                      B bound) {
  int32_t result = 0, decided = 0;
#pragma unroll
  for (int i = NL - 1; i >= 0; --i) {
    const int32_t b = bound(i);
    const int32_t gt = x[i] > b, lt = x[i] < b;
    result |= (decided ^ 1) & gt;
    decided |= gt | lt;
  }
  return result | (decided ^ 1);
}

// 1 where the two limb vectors are equal.
__host__ __device__ __forceinline__ int32_t limbs_eq(const int32_t (&x)[NL],
                                                     const int32_t (&y)[NL]) {
  int32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) acc |= x[i] ^ y[i];
  return acc == 0;
}

}  // namespace zc32
