// The 8 x 32-bit field core of k_bucket_accum (csrc/msm_kernels.cu): field
// arithmetic over p = 2^252 + delta (delta < 2^125) in Montgomery form, and
// the unified Edwards addition built from it.  Only k_bucket_accum and its
// prep kernel include this header; every other kernel keeps the 22 x 12-bit
// limbs of field.cuh.
//
// Why 32-bit words: Hopper multiplies 32 x 32 -> 64 bits (IMAD.WIDE.U32),
// which the TPU lacked; that lack is the only reason for the 12-bit radix.
// A field element is 8 uint32 words -- an extended point 32 registers, not
// 88 -- and a multiply is 64 word products plus the reduction.
//
// Why Montgomery (R = 2^256) and not a fold on 2^252 == -delta: p's words
// are (delta_0..3, 0, 0, 0, 2^28), so the CIOS reduction step m * p costs
// 4 word products and a shift, 8 x 5 in all, and every intermediate stays
// unsigned.  The fold would take 9 x 4 + 5 x 4 products on a signed
// remainder.  Montgomery form costs one conversion at each edge of the
// kernel (to_mont / to_limbs), which a bucket table amortizes over all
// its additions.
//
// Invariant: every Fe holds a value in [0, p), in Montgomery form a R mod
// p.  mul's CIOS output is below 2p for inputs below p (p < R / 8) and
// takes one conditional subtraction, as add and sub do; the kernel's
// output is therefore canonical with no further work.
//
// Every function is __host__ __device__ __forceinline__ plain C++ with
// uint64_t products (no inline PTX), so tests/test_torch_field32_host.py
// compiles this same header for the host with g++ and holds it against
// the oracle.

#pragma once

#include <stdint.h>

namespace zc32 {

constexpr int NW = 8;                  // words per element
constexpr int NL = 22;                 // limbs of the 22 x 12-bit boundary
constexpr int LW = 12;                 // radix bits of those limbs

// p = 2^252 + delta, little-endian words; words 4..6 are zero.
constexpr uint32_t P0 = 0x5cf5d3edu, P1 = 0x5812631au, P2 = 0xa2f79cd6u,
                   P3 = 0x14def9deu, P7 = 0x10000000u;
constexpr uint32_t PINV = 0x12547e1bu;  // -p^-1 mod 2^32

struct Fe {
  uint32_t w[NW];
};

// Extended point (X, Y, Z, T): 32 words.
struct Pt {
  Fe X, Y, Z, T;
};

__host__ __device__ __forceinline__ uint32_t p_word(int i) {
  return i == 0 ? P0 : i == 1 ? P1 : i == 2 ? P2 : i == 3 ? P3
       : i == 7 ? P7 : 0u;
}

// R^2 mod p (to_mont) and R mod p (the Montgomery one).
__host__ __device__ __forceinline__ uint32_t r2_word(int i) {
  constexpr uint32_t v[NW] = {0x449c0f01u, 0xa40611e3u, 0x68859347u,
                              0xd00e1ba7u, 0x17f5be65u, 0xceec73d2u,
                              0x7c309a3du, 0x0399411bu};
  return v[i];
}

__host__ __device__ __forceinline__ uint32_t one_word(int i) {
  constexpr uint32_t v[NW] = {0x8d98951du, 0xd6ec3174u, 0x737dcf70u,
                              0xc6ef5bf4u, 0xfffffffeu, 0xffffffffu,
                              0xffffffffu, 0x0fffffffu};
  return v[i];
}

__host__ __device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = 0;
  return r;
}

__host__ __device__ __forceinline__ Fe fe_one() {
  Fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = one_word(i);
  return r;
}

// r = x - p if x >= p (x < 2p, given as 8 words and a top word hi).
__host__ __device__ __forceinline__ Fe sub_p_if_geq(const uint32_t (&x)[NW],
                                                    uint32_t hi) {
  Fe d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint64_t t = (uint64_t)x[i] - p_word(i) - borrow;
    d.w[i] = (uint32_t)t;
    borrow = (t >> 32) & 1;
  }
  // x >= p exactly when the subtraction did not borrow past the top word
  const uint32_t keep = (uint32_t)(hi == 0 && borrow) * 0xffffffffu;
  Fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = (x[i] & keep) | (d.w[i] & ~keep);
  return r;
}

// a + b mod p.
__host__ __device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  uint32_t s[NW];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c = (uint64_t)a.w[i] + b.w[i] + (c >> 32);
    s[i] = (uint32_t)c;
  }
  return sub_p_if_geq(s, (uint32_t)(c >> 32));
}

// a - b mod p: add p back where the subtraction borrowed.
__host__ __device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
  Fe r;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint64_t t = (uint64_t)a.w[i] - b.w[i] - borrow;
    r.w[i] = (uint32_t)t;
    borrow = (t >> 32) & 1;
  }
  const uint32_t mask = (uint32_t)borrow * 0xffffffffu;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c = (uint64_t)r.w[i] + (p_word(i) & mask) + (c >> 32);
    r.w[i] = (uint32_t)c;
  }
  return r;
}

__host__ __device__ __forceinline__ Fe fe_neg(const Fe& a) {
  return fe_sub(fe_zero(), a);
}

// Montgomery product a b R^-1 mod p by CIOS: per word b_i, t += a b_i,
// then t += m p with m = t_0 (-p^-1) mod 2^32 and shift one word.  The
// zero words of p are skipped, and m * P7 is a shift.  t stays below 2p.
__host__ __device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int j = 0; j < NW + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      c = (uint64_t)a.w[j] * b.w[i] + t[j] + (c >> 32);
      t[j] = (uint32_t)c;
    }
    c = (uint64_t)t[NW] + (c >> 32);
    t[NW] = (uint32_t)c;
    t[NW + 1] = (uint32_t)(c >> 32);

    const uint32_t m = t[0] * PINV;
    c = (uint64_t)m * P0 + t[0];                  // low word becomes 0
    c = (uint64_t)m * P1 + t[1] + (c >> 32);
    t[0] = (uint32_t)c;
    c = (uint64_t)m * P2 + t[2] + (c >> 32);
    t[1] = (uint32_t)c;
    c = (uint64_t)m * P3 + t[3] + (c >> 32);
    t[2] = (uint32_t)c;
#pragma unroll
    for (int j = 4; j < 7; ++j) {
      c = (uint64_t)t[j] + (c >> 32);
      t[j - 1] = (uint32_t)c;
    }
    c = ((uint64_t)m << 28) + t[7] + (c >> 32);   // m * P7
    t[6] = (uint32_t)c;
    c = (uint64_t)t[NW] + (c >> 32);
    t[7] = (uint32_t)c;
    t[NW] = t[NW + 1] + (uint32_t)(c >> 32);
  }
  uint32_t lo[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) lo[j] = t[j];
  return sub_p_if_geq(lo, t[NW]);
}

// Montgomery square: the 16-word square (each cross product once,
// doubled), then 8 reduction steps on it (SOS).
__host__ __device__ __forceinline__ Fe fe_sq(const Fe& a) {
  uint32_t t[2 * NW + 1];
#pragma unroll
  for (int j = 0; j < 2 * NW + 1; ++j) t[j] = 0;
  // cross products a_i a_j, i < j
#pragma unroll
  for (int i = 0; i < NW - 1; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = i + 1; j < NW; ++j) {
      c = (uint64_t)a.w[i] * a.w[j] + t[i + j] + (c >> 32);
      t[i + j] = (uint32_t)c;
    }
    t[i + NW] = (uint32_t)(c >> 32);
  }
  // double them, then add the squares a_i^2
  uint32_t top = 0;
#pragma unroll
  for (int j = 2 * NW - 1; j >= 1; --j) {
    const uint32_t v = t[j];
    if (j == 2 * NW - 1) top = v >> 31;
    t[j] = (v << 1) | (t[j - 1] >> 31);
  }
  t[0] <<= 1;
  t[2 * NW] = top;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c = (uint64_t)a.w[i] * a.w[i] + t[2 * i] + (c >> 32);
    t[2 * i] = (uint32_t)c;
    c = (uint64_t)t[2 * i + 1] + (c >> 32);
    t[2 * i + 1] = (uint32_t)c;
  }
  t[2 * NW] += (uint32_t)(c >> 32);
  // reduction: t += m p at word i, carried to the top
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t m = t[i] * PINV;
    c = (uint64_t)m * P0 + t[i];
    c = (uint64_t)m * P1 + t[i + 1] + (c >> 32);
    t[i + 1] = (uint32_t)c;
    c = (uint64_t)m * P2 + t[i + 2] + (c >> 32);
    t[i + 2] = (uint32_t)c;
    c = (uint64_t)m * P3 + t[i + 3] + (c >> 32);
    t[i + 3] = (uint32_t)c;
#pragma unroll
    for (int j = i + 4; j < i + 7; ++j) {
      c = (uint64_t)t[j] + (c >> 32);
      t[j] = (uint32_t)c;
    }
    c = ((uint64_t)m << 28) + t[i + 7] + (c >> 32);
    t[i + 7] = (uint32_t)c;
#pragma unroll
    for (int j = i + 8; j <= 2 * NW; ++j) {
      c = (uint64_t)t[j] + (c >> 32);
      t[j] = (uint32_t)c;
    }
  }
  uint32_t hi[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) hi[j] = t[NW + j];
  return sub_p_if_geq(hi, t[2 * NW]);
}

// ---------------------------------------------------------------------------
// The 22 x 12-bit boundary
// ---------------------------------------------------------------------------

// Signed lazy 22 x 12-bit limbs (any int32 values, as the limb engine
// makes them: the top limb carries the sign) -> the value mod p in [0, p),
// not yet in Montgomery form.  One carry pass in 64 bits leaves limbs
// 0..20 in [0, 2^12), so value = lo + hi 2^252 with lo < 2^252 and
// |hi| < 2^32; then value == lo - hi delta (mod p), and one conditional
// correction by p lands in [0, p).
__host__ __device__ __forceinline__ Fe from_limbs(const int32_t (&x)[NL]) {
  int64_t v[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) v[k] = x[k];
#pragma unroll
  for (int k = 0; k < NL - 1; ++k) {
    v[k + 1] += v[k] >> LW;                       // arithmetic shift
    v[k] &= (1 << LW) - 1;
  }
  uint32_t lo[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) lo[i] = 0;
#pragma unroll
  for (int k = 0; k < NL - 1; ++k) {
    const int bit = LW * k, i = bit / 32, s = bit % 32;
    lo[i] |= (uint32_t)v[k] << s;
    if (s > 32 - LW) lo[i + 1] |= (uint32_t)v[k] >> (32 - s);
  }
  const int64_t hi = v[NL - 1];
  const uint32_t neg = (uint32_t)(hi < 0) * 0xffffffffu;
  const uint32_t h = (uint32_t)(hi < 0 ? -hi : hi);
  // hd = |hi| delta: 5 words
  uint32_t hd[NW];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c = (uint64_t)h * p_word(i) + (c >> 32);
    hd[i] = (uint32_t)c;
  }
  hd[4] = (uint32_t)(c >> 32);
  hd[5] = hd[6] = hd[7] = 0;
  // w = lo + hd (hi < 0) or lo - hd (hi >= 0), as lo + (hd ^ neg') + ...:
  // compute both and select.
  uint32_t sum[NW], dif[NW];
  uint64_t cs = 0, bd = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    cs = (uint64_t)lo[i] + hd[i] + (cs >> 32);
    sum[i] = (uint32_t)cs;
    const uint64_t t = (uint64_t)lo[i] - hd[i] - bd;
    dif[i] = (uint32_t)t;
    bd = (t >> 32) & 1;
  }
  // lo - hd < 0: add p (the result is then in (p - 2^157, p))
  const uint32_t add_p = (uint32_t)bd * 0xffffffffu;
  c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c = (uint64_t)dif[i] + (p_word(i) & add_p) + (c >> 32);
    dif[i] = (uint32_t)c;
  }
  // lo + hd < 2^252 + 2^157 < 2p: subtract p once if it reaches p
  const Fe s = sub_p_if_geq(sum, 0);
  Fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = (s.w[i] & neg) | (dif[i] & ~neg);
  return r;
}

// Value in [0, p) -> Montgomery form, and back.
__host__ __device__ __forceinline__ Fe to_mont(const Fe& a) {
  Fe r2;
#pragma unroll
  for (int i = 0; i < NW; ++i) r2.w[i] = r2_word(i);
  return fe_mul(a, r2);
}

__host__ __device__ __forceinline__ Fe from_mont(const Fe& a) {
  Fe one = fe_zero();
  one.w[0] = 1;
  return fe_mul(a, one);
}

// Montgomery form -> canonical 22 x 12-bit limbs (limb 21 is 0 or 1).
__host__ __device__ __forceinline__ void to_limbs(const Fe& a,
                                                  int32_t (&out)[NL]) {
  const Fe v = from_mont(a);
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const int bit = LW * k, i = bit / 32, s = bit % 32;
    uint32_t x = v.w[i] >> s;
    if (s > 32 - LW && i + 1 < NW) x |= v.w[i + 1] << (32 - s);
    out[k] = (int32_t)(x & ((1u << LW) - 1));
  }
}

// ---------------------------------------------------------------------------
// Edwards addition over p (a = -1)
// ---------------------------------------------------------------------------

// Unified extended HWCD addition R = P + Q, 10 multiplies, in the order
// of field.cuh's padd_ext: the same formula gives the same field values,
// whatever the representation.  d is the curve constant in Montgomery
// form.  R may alias P or Q.
__host__ __device__ __forceinline__ void padd_ext(Pt& R, const Pt& P,
                                                  const Pt& Q, const Fe& d) {
  const Fe S = fe_mul(fe_add(P.X, P.Y), fe_add(Q.X, Q.Y));
  const Fe A = fe_mul(P.X, Q.X);
  const Fe B = fe_mul(P.Y, Q.Y);
  const Fe Cc = fe_mul(fe_mul(P.T, Q.T), d);
  const Fe Dd = fe_mul(P.Z, Q.Z);
  const Fe E = fe_sub(fe_sub(S, A), B);
  const Fe F = fe_sub(Dd, Cc);
  const Fe G = fe_add(Dd, Cc);
  const Fe H = fe_add(A, B);
  R.X = fe_mul(E, F);
  R.Y = fe_mul(G, H);
  R.Z = fe_mul(F, G);
  R.T = fe_mul(E, H);
}

}  // namespace zc32
