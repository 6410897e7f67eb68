// The 8 x 32-bit field core of the Hopper kernels: arithmetic modulo m =
// 2^(224 + s) + delta (delta < 2^125, s = 28 for the field prime p, s = 25
// for the group order r) in Montgomery form, and the Edwards formulas over
// p built from it.  Every kernel computes on it: k_bucket_accum (K7, K9,
// K11, K12) and k_combine (K8) in csrc/msm_kernels.cu, and k_mul (K1, both
// moduli), k_pow (K2, both moduli; csrc/pow32.cuh), k_ladder (K3, K4, K10;
// csrc/ladder32.cuh), k_padd (K5) and k_comb (K6; csrc/comb32.cuh) in
// csrc/field_kernels.cu.
//
// Why 32-bit words: Hopper multiplies 32 x 32 -> 64 bits (IMAD.WIDE.U32),
// which the TPU lacked; that lack is the only reason for the 12-bit radix.
// A field element is 8 uint32 words -- an extended point 32 registers, not
// 88 -- and a multiply is 64 word products plus the reduction.
//
// Why Montgomery (R = 2^256) and not a fold on 2^252 == -delta: m's words
// are (delta_0..3, 0, 0, 0, 2^s), so the CIOS reduction step q * m costs 4
// word products and a shift, 8 x 5 in all, and every intermediate stays
// unsigned.  The fold would take 9 x 4 + 5 x 4 products on a signed
// remainder.  Montgomery form costs one conversion at each edge of the
// kernel (to_mont / to_limbs), which a bucket table, a ladder or a power
// chain amortizes over all its multiplies.
//
// The modulus is a template parameter, a struct of its constants (ModP,
// ModR below); every function takes ModP by default, so the kernels on p
// name none.  The point formulas are over p only.
//
// Invariant: every Fe holds a value in [0, m), in Montgomery form a R mod
// m.  mul's CIOS output is below 2m for inputs below m (m < R / 8) and
// takes one conditional subtraction, as add and sub do; the kernels'
// outputs are therefore canonical with no further work.
//
// Constant time: every function here is branch-free on the values it
// computes (selections are masks), so the oblivious ladder can use them.
//
// Every function is __host__ __device__ __forceinline__ plain C++ with
// uint64_t products, so tests/test_torch_field32_host.py compiles this
// same header for the host with g++ and holds it against the oracle; only
// the multiply's step (mont_step) takes PTX carry chains on the card.

#pragma once

#include <stdint.h>

namespace zc32 {

constexpr int NW = 8;                  // words per element
constexpr int NL = 22;                 // limbs of the 22 x 12-bit boundary
constexpr int LW = 12;                 // radix bits of those limbs

struct Fe {
  uint32_t w[NW];
};

// Extended point (X, Y, Z, T): 32 words.
struct Pt {
  Fe X, Y, Z, T;
};

// The curve constants d and 2d in Montgomery form, d R mod p and 2d R mod
// p (tests/test_torch_field32_host.py holds these words equal to them).
// Each kernel library has its own copy; the kernels read them as
// constant-bank operands, so they take no registers.
__constant__ Fe c_d32 = {{0xa911bcacu, 0x4dc31488u, 0x96c021a0u, 0x150160ffu,
                          0xf2abb033u, 0x6960412fu, 0x953fedb5u, 0x0bcdf760u}};
__constant__ Fe c_d2_32 = {{0xf52da56bu, 0x4373c5f6u, 0x8a88a66au,
                            0x1523c820u, 0xe5576066u, 0xd2c0825fu,
                            0x2a7fdb6au, 0x079beec1u}};

// Word f (0..31) of a point's X, Y, Z, T.  f is a compile-time constant
// under the unrolled loops, so the select resolves statically.
__host__ __device__ __forceinline__ uint32_t& pt_word(Pt& p, int f) {
  return f < NW ? p.X.w[f] : f < 2 * NW ? p.Y.w[f - NW]
       : f < 3 * NW ? p.Z.w[f - 2 * NW] : p.T.w[f - 3 * NW];
}

// Coordinate c (0..3) of a point: X, Y, Z, T.
__host__ __device__ __forceinline__ const Fe& coord(const Pt& p, int c) {
  return c == 0 ? p.X : c == 1 ? p.Y : c == 2 ? p.Z : p.T;
}

// A modulus m = 2^(224 + TOP) + delta: its words are (W0..W3, 0, 0, 0,
// 2^TOP).  INV = -m^-1 mod 2^32; one(i), r2(i) and r4(i) are the words of
// R mod m (the Montgomery one), R^2 mod m (to_mont) and R^4 mod m (a
// Montgomery product with it lifts x R^-1 to x R^2: k_padd).
struct ModP {                          // p = 2^252 + delta
  static constexpr uint32_t W0 = 0x5cf5d3edu, W1 = 0x5812631au,
                            W2 = 0xa2f79cd6u, W3 = 0x14def9deu;
  static constexpr int TOP = 28;
  static constexpr uint32_t INV = 0x12547e1bu;
  static __host__ __device__ __forceinline__ uint32_t one(int i) {
    constexpr uint32_t v[NW] = {0x8d98951du, 0xd6ec3174u, 0x737dcf70u,
                                0xc6ef5bf4u, 0xfffffffeu, 0xffffffffu,
                                0xffffffffu, 0x0fffffffu};
    return v[i];
  }
  static __host__ __device__ __forceinline__ uint32_t r2(int i) {
    constexpr uint32_t v[NW] = {0x449c0f01u, 0xa40611e3u, 0x68859347u,
                                0xd00e1ba7u, 0x17f5be65u, 0xceec73d2u,
                                0x7c309a3du, 0x0399411bu};
    return v[i];
  }
  static __host__ __device__ __forceinline__ uint32_t r4(int i) {
    constexpr uint32_t v[NW] = {0x42419a0du, 0x3a3dc222u, 0x023493f7u,
                                0x9d31cab2u, 0xb6870058u, 0xe7faf80eu,
                                0x5a45ffd7u, 0x09dc924eu};
    return v[i];
  }
};

struct ModR {                          // r = 2^249 + delta_r
  static constexpr uint32_t W0 = 0x755fc863u, W1 = 0x6ab4036fu,
                            W2 = 0x822fd593u, W3 = 0x0ae6c74du;
  static constexpr int TOP = 25;
  static constexpr uint32_t INV = 0x84a706b5u;
  static __host__ __device__ __forceinline__ uint32_t one(int i) {
    constexpr uint32_t v[NW] = {0xc57b96e3u, 0x10b24bb4u, 0x6a450bdeu,
                                0x9783208cu, 0xfffffffau, 0xffffffffu,
                                0xffffffffu, 0x01ffffffu};
    return v[i];
  }
  static __host__ __device__ __forceinline__ uint32_t r2(int i) {
    constexpr uint32_t v[NW] = {0x050c31b2u, 0xfcbbafc0u, 0x48fd51d3u,
                                0x0d536753u, 0x98d542e5u, 0x0509b170u,
                                0xd0a04e90u, 0x01e73226u};
    return v[i];
  }
  static __host__ __device__ __forceinline__ uint32_t r4(int i) {
    constexpr uint32_t v[NW] = {0x364b0effu, 0xfeedb71eu, 0x5c9e4192u,
                                0x28af3a50u, 0x79210933u, 0x5a1d5183u,
                                0xdac3a770u, 0x017c5642u};
    return v[i];
  }
};

// Word i of the modulus.
template <class M>
__host__ __device__ __forceinline__ uint32_t m_word(int i) {
  return i == 0 ? M::W0 : i == 1 ? M::W1 : i == 2 ? M::W2 : i == 3 ? M::W3
       : i == 7 ? 1u << M::TOP : 0u;
}

__host__ __device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = 0;
  return r;
}

template <class M = ModP>
__host__ __device__ __forceinline__ Fe fe_one() {
  Fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = M::one(i);
  return r;
}

// c ? a : b, by mask.
__host__ __device__ __forceinline__ Fe fe_pick(bool c, const Fe& a,
                                               const Fe& b) {
  const uint32_t m = 0u - (uint32_t)c;
  Fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = (a.w[i] & m) | (b.w[i] & ~m);
  return r;
}

// r = x - m if x >= m (x < 2m, given as 8 words and a top word hi).
template <class M = ModP>
__host__ __device__ __forceinline__ Fe sub_p_if_geq(const uint32_t (&x)[NW],
                                                    uint32_t hi) {
  Fe d;
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint64_t t = (uint64_t)x[i] - m_word<M>(i) - borrow;
    d.w[i] = (uint32_t)t;
    borrow = (t >> 32) & 1;
  }
  // x >= m exactly when the subtraction did not borrow past the top word
  const uint32_t keep = 0u - ((uint32_t)(hi == 0) & (uint32_t)borrow);
  Fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = (x[i] & keep) | (d.w[i] & ~keep);
  return r;
}

// a + b mod m.
template <class M = ModP>
__host__ __device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  uint32_t s[NW];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c = (uint64_t)a.w[i] + b.w[i] + (c >> 32);
    s[i] = (uint32_t)c;
  }
  return sub_p_if_geq<M>(s, (uint32_t)(c >> 32));
}

// a - b mod m: add m back where the subtraction borrowed.
template <class M = ModP>
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
    c = (uint64_t)r.w[i] + (m_word<M>(i) & mask) + (c >> 32);
    r.w[i] = (uint32_t)c;
  }
  return r;
}

template <class M = ModP>
__host__ __device__ __forceinline__ Fe fe_neg(const Fe& a) {
  return fe_sub<M>(fe_zero(), a);
}

// a / 2 mod m: a, plus m where a is odd, shifted down one bit (a + m <
// 2m < 2^256, so nothing carries out).
template <class M = ModP>
__host__ __device__ __forceinline__ Fe fe_half(const Fe& a) {
  const uint32_t odd = 0u - (a.w[0] & 1u);
  uint32_t s[NW];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c = (uint64_t)a.w[i] + (m_word<M>(i) & odd) + (c >> 32);
    s[i] = (uint32_t)c;
  }
  Fe r;
#pragma unroll
  for (int i = 0; i < NW - 1; ++i) r.w[i] = (s[i] >> 1) | (s[i + 1] << 31);
  r.w[NW - 1] = s[NW - 1] >> 1;
  return r;
}

// One CIOS step of the Montgomery product: t += a b, then t += q m with
// q = t_0 (-m^-1) mod 2^32 (t_0 becomes 0), and t shifts down one word.
// t has NW + 2 words and stays below 2^288 (m < 2^253 and t < 2m before
// the step), so nothing carries out of t_8.  The zero words of m are
// skipped, and q * 2^TOP, its top word's product, is a shift.
//
// On the card the step is PTX carry chains (the carry flag lives only
// inside one asm statement): a word product becomes an IMAD and an
// IMAD.HI that add with carry, where the C++ below costs an IMAD.WIDE.U32
// and two or three adds and moves: 68 SASS instructions a step against
// 76, in shorter dependences (the ladders ran 20 % faster on an H100,
// PERF.md).  M's constants enter as immediates.  The host compiles the
// C++, which tests/test_torch_field32_host.py holds against the oracle;
// the card's step is held against the plain versions by the `cuda` tests
// and chip_smoke.py.
template <class M = ModP>
__host__ __device__ __forceinline__ void mont_step(uint32_t (&t)[NW + 2],
                                                   const Fe& a, uint32_t b) {
#ifdef __CUDA_ARCH__
  asm("{\n\t"
      ".reg .u32 m, x, y;\n\t"
      "mad.lo.cc.u32  %0, %9, %17, %0;\n\t"
      "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
      "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
      "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
      "addc.u32       %8, %8, 0;\n\t"
      "mad.hi.cc.u32  %1, %9, %17, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %17, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %17, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %17, %6;\n\t"
      "madc.hi.cc.u32 %7, %15, %17, %7;\n\t"
      "madc.hi.u32    %8, %16, %17, %8;\n\t"
      "mul.lo.u32     m, %0, %18;\n\t"
      "shl.b32        x, m, %23;\n\t"
      "shr.u32        y, m, %24;\n\t"
      "mad.lo.cc.u32  %0, m, %19, %0;\n\t"
      "madc.lo.cc.u32 %1, m, %20, %1;\n\t"
      "madc.lo.cc.u32 %2, m, %21, %2;\n\t"
      "madc.lo.cc.u32 %3, m, %22, %3;\n\t"
      "addc.cc.u32    %4, %4, 0;\n\t"
      "addc.cc.u32    %5, %5, 0;\n\t"
      "addc.cc.u32    %6, %6, 0;\n\t"
      "addc.cc.u32    %7, %7, x;\n\t"
      "addc.u32       %8, %8, y;\n\t"
      "mad.hi.cc.u32  %1, m, %19, %1;\n\t"
      "madc.hi.cc.u32 %2, m, %20, %2;\n\t"
      "madc.hi.cc.u32 %3, m, %21, %3;\n\t"
      "madc.hi.cc.u32 %4, m, %22, %4;\n\t"
      "addc.cc.u32    %5, %5, 0;\n\t"
      "addc.cc.u32    %6, %6, 0;\n\t"
      "addc.cc.u32    %7, %7, 0;\n\t"
      "addc.u32       %8, %8, 0;\n\t"
      "}"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8])
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]),
        "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]), "r"(b), "n"(M::INV),
        "n"(M::W0), "n"(M::W1), "n"(M::W2), "n"(M::W3), "n"(M::TOP),
        "n"(32 - M::TOP));
#pragma unroll
  for (int j = 0; j < NW; ++j) t[j] = t[j + 1];
  t[NW] = 0;
#else
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    c = (uint64_t)a.w[j] * b + t[j] + (c >> 32);
    t[j] = (uint32_t)c;
  }
  c = (uint64_t)t[NW] + (c >> 32);
  t[NW] = (uint32_t)c;
  t[NW + 1] = (uint32_t)(c >> 32);

  const uint32_t m = t[0] * M::INV;
  c = (uint64_t)m * M::W0 + t[0];                 // low word becomes 0
  c = (uint64_t)m * M::W1 + t[1] + (c >> 32);
  t[0] = (uint32_t)c;
  c = (uint64_t)m * M::W2 + t[2] + (c >> 32);
  t[1] = (uint32_t)c;
  c = (uint64_t)m * M::W3 + t[3] + (c >> 32);
  t[2] = (uint32_t)c;
#pragma unroll
  for (int j = 4; j < 7; ++j) {
    c = (uint64_t)t[j] + (c >> 32);
    t[j - 1] = (uint32_t)c;
  }
  c = ((uint64_t)m << M::TOP) + t[7] + (c >> 32);   // m times the top word
  t[6] = (uint32_t)c;
  c = (uint64_t)t[NW] + (c >> 32);
  t[7] = (uint32_t)c;
  t[NW] = t[NW + 1] + (uint32_t)(c >> 32);
#endif
}

// Montgomery product a b R^-1 mod m by CIOS, one mont_step a word of b.
// t stays below 2m.  The loop over b's words stays rolled (b's words
// shift down one a step, so every index is static): unrolled, a multiply
// is some 600 instructions, and a kernel's dozens of inlined multiplies
// outgrew the instruction cache and the registers -- k_padd's
// lane-reduce round took 4.3 ms unrolled and 1.9 rolled, k_ladder spilled
// 52 bytes unrolled and none rolled (on an H100, PERF.md).
template <class M = ModP>
__host__ __device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int j = 0; j < NW + 2; ++j) t[j] = 0;
  uint32_t bw[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) bw[j] = b.w[j];
#pragma unroll 1
  for (int i = 0; i < NW; ++i) {
    const uint32_t bi = bw[0];
#pragma unroll
    for (int j = 0; j < NW - 1; ++j) bw[j] = bw[j + 1];
    mont_step<M>(t, a, bi);
  }
  uint32_t lo[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) lo[j] = t[j];
  return sub_p_if_geq<M>(lo, t[NW]);
}

// Montgomery square: the multiply.  A square by SOS (fe_sq_sos, below)
// holds the 16 words of its product at once; in the ladder's doublings,
// four of them side by side spilled more registers and ran slower than
// four multiplies.
template <class M = ModP>
__host__ __device__ __forceinline__ Fe fe_sq(const Fe& a) {
  return fe_mul<M>(a, a);
}

// Montgomery square by SOS: the 28 cross products once, doubled, the 8
// squares, then 8 reduction steps (4 word products and a shift each) with
// a delayed carry word, unrolled C++: 36 word products and the reduction's
// 32, against the multiply's 104.  The result stays below 2m.  It holds
// the 16 words of the square at once, so only the kernels with registers
// to spare take it: k_pow's chain (248 of its ~310 operations) and
// k_combine's doublings ran 21 % and 9 % faster with it than with fe_sq
// (on an H100, PERF.md).
template <class M = ModP>
__host__ __device__ __forceinline__ Fe fe_sq_sos(const Fe& a) {
  uint32_t t[2 * NW];
#pragma unroll
  for (int k = 0; k < 2 * NW; ++k) t[k] = 0;
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
#pragma unroll
  for (int k = 2 * NW - 1; k > 0; --k) t[k] = (t[k] << 1) | (t[k - 1] >> 31);
  t[0] = 0;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint64_t s = (uint64_t)a.w[i] * a.w[i];
    c = (uint64_t)t[2 * i] + (uint32_t)s + (c >> 32);
    t[2 * i] = (uint32_t)c;
    c = (uint64_t)t[2 * i + 1] + (s >> 32) + (c >> 32);
    t[2 * i + 1] = (uint32_t)c;
  }
  uint32_t top = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint32_t m = t[i] * M::INV;
    c = (uint64_t)m * M::W0 + t[i];
    c = (uint64_t)m * M::W1 + t[i + 1] + (c >> 32);
    t[i + 1] = (uint32_t)c;
    c = (uint64_t)m * M::W2 + t[i + 2] + (c >> 32);
    t[i + 2] = (uint32_t)c;
    c = (uint64_t)m * M::W3 + t[i + 3] + (c >> 32);
    t[i + 3] = (uint32_t)c;
#pragma unroll
    for (int k = 4; k < 7; ++k) {
      c = (uint64_t)t[i + k] + (c >> 32);
      t[i + k] = (uint32_t)c;
    }
    c = ((uint64_t)m << M::TOP) + t[i + 7] + (c >> 32);
    t[i + 7] = (uint32_t)c;
    c = (uint64_t)t[i + NW] + top + (c >> 32);
    t[i + NW] = (uint32_t)c;
    top = (uint32_t)(c >> 32);
  }
  uint32_t hi[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) hi[k] = t[NW + k];
  return sub_p_if_geq<M>(hi, top);
}

// ---------------------------------------------------------------------------
// The 22 x 12-bit boundary
// ---------------------------------------------------------------------------

// Signed lazy 22 x 12-bit limbs (any int32 values, as the limb engine
// makes them: the top limb carries the sign) -> the value mod m in [0, m),
// not yet in Montgomery form.  One carry pass in 64 bits, from the bottom
// limb up, leaves limbs 0..20 in [0, 2^12), packed into lo as they come,
// so value = lo + hi 2^252 with lo < 2^252 and |hi| < 2^32.  Below p
// (2^252 = 2^(224 + TOP)) lo stays whole; below r (2^249) lo's bits from
// 2^249 up join hi, h = hi 2^3 + (lo >> 249), |h| < 2^36.  Then value ==
// lo - h delta (mod m), |h| delta < 2^161, and one conditional correction
// by m lands in [0, m).
template <class M = ModP>
__host__ __device__ __forceinline__ Fe from_limbs(const int32_t (&x)[NL]) {
  uint32_t lo[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) lo[i] = 0;
  int64_t carry = 0;
#pragma unroll
  for (int k = 0; k < NL - 1; ++k) {
    const int64_t v = x[k] + carry;
    carry = v >> LW;                              // arithmetic shift
    const uint32_t limb = (uint32_t)v & ((1u << LW) - 1);
    const int bit = LW * k, i = bit / 32, s = bit % 32;
    lo[i] |= limb << s;
    if (s > 32 - LW) lo[i + 1] |= limb >> (32 - s);
  }
  int64_t hi = x[NL - 1] + carry;
  constexpr bool WIDE = M::TOP < 28;              // 2^(224 + TOP) < 2^252
  if constexpr (WIDE) {
    hi = hi * (int64_t{1} << (28 - M::TOP)) + (lo[NW - 1] >> M::TOP);
    lo[NW - 1] &= (1u << M::TOP) - 1;
  }
  const int64_t sgn = hi >> 63;                   // 0 or -1
  const uint32_t neg = (uint32_t)sgn;
  const uint64_t h = (uint64_t)((hi ^ sgn) - sgn);  // |h|, by mask
  // hd = |h| delta: 5 words, 6 where h takes more than 32 bits
  uint32_t hd[NW];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c = (uint64_t)(uint32_t)h * m_word<M>(i) + (c >> 32);
    hd[i] = (uint32_t)c;
  }
  hd[4] = (uint32_t)(c >> 32);
  hd[5] = hd[6] = hd[7] = 0;
  if constexpr (WIDE) {
    const uint32_t h1 = (uint32_t)(h >> 32);
    c = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      c = (uint64_t)h1 * m_word<M>(i) + hd[i + 1] + (c >> 32);
      hd[i + 1] = (uint32_t)c;
    }
    hd[5] = (uint32_t)(c >> 32);
  }
  // w = lo + hd (h < 0) or lo - hd (h >= 0), as lo + (hd ^ neg') + ...:
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
  // lo - hd < 0: add m (the result is then in (m - 2^161, m))
  const uint32_t add_m = (uint32_t)bd * 0xffffffffu;
  c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c = (uint64_t)dif[i] + (m_word<M>(i) & add_m) + (c >> 32);
    dif[i] = (uint32_t)c;
  }
  // lo + hd < 2^(224 + TOP) + 2^161 < 2m: subtract m once if it reaches m
  const Fe s = sub_p_if_geq<M>(sum, 0);
  Fe r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = (s.w[i] & neg) | (dif[i] & ~neg);
  return r;
}

// Value in [0, m) -> Montgomery form, and back.
template <class M = ModP>
__host__ __device__ __forceinline__ Fe to_mont(const Fe& a) {
  Fe r2;
#pragma unroll
  for (int i = 0; i < NW; ++i) r2.w[i] = M::r2(i);
  return fe_mul<M>(a, r2);
}

template <class M = ModP>
__host__ __device__ __forceinline__ Fe from_mont(const Fe& a) {
  Fe one = fe_zero();
  one.w[0] = 1;
  return fe_mul<M>(a, one);
}

// A value in [0, 2^253) -> canonical 22 x 12-bit limbs (limb 21 is 0 or 1).
__host__ __device__ __forceinline__ void pack_limbs(const Fe& v,
                                                    int32_t (&out)[NL]) {
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const int bit = LW * k, i = bit / 32, s = bit % 32;
    uint32_t x = v.w[i] >> s;
    if (s > 32 - LW && i + 1 < NW) x |= v.w[i + 1] << (32 - s);
    out[k] = (int32_t)(x & ((1u << LW) - 1));
  }
}

// Montgomery form -> canonical 22 x 12-bit limbs.
template <class M = ModP>
__host__ __device__ __forceinline__ void to_limbs(const Fe& a,
                                                  int32_t (&out)[NL]) {
  pack_limbs(from_mont<M>(a), out);
}

// k_mul's lane (K1): a b mod m for two signed lazy 22 x 12 operands, as a
// plain value in [0, m) for pack_limbs.  A Montgomery product of a plain a
// and b R is a b: two multiplies (to_mont, then the product) and no
// conversion out.
template <class M = ModP>
__host__ __device__ __forceinline__ Fe mul_limbs(const int32_t (&a)[NL],
                                                 const int32_t (&b)[NL]) {
  return fe_mul<M>(from_limbs<M>(a), to_mont<M>(from_limbs<M>(b)));
}

// ---------------------------------------------------------------------------
// Edwards addition over p (a = -1)
// ---------------------------------------------------------------------------

// Each formula is its plain version's (ops/kernels/field_kernels.py, on
// the 22 x 12 limbs of ops/limb.py), term for term: the same formula gives
// the same field values, whatever the representation, so a kernel on this
// core and its plain version agree on canonical limbs.

// Unified extended HWCD addition R = P + Q, 10 multiplies, with Q's
// coordinate c read by q(c) where the formula first needs it (X and Y,
// then T, then Z), so a caller may keep Q out of registers.  d is the
// curve constant in Montgomery form.  R may alias P.
template <class Load>
__host__ __device__ __forceinline__ void padd_ext_by(Pt& R, const Pt& P,
                                                     const Load& q,
                                                     const Fe& d) {
  const Fe QX = q(0), QY = q(1);
  const Fe S = fe_mul(fe_add(P.X, P.Y), fe_add(QX, QY));
  const Fe A = fe_mul(P.X, QX);
  const Fe B = fe_mul(P.Y, QY);
  const Fe Cc = fe_mul(fe_mul(P.T, q(3)), d);
  const Fe Dd = fe_mul(P.Z, q(2));
  const Fe E = fe_sub(fe_sub(S, A), B);
  const Fe F = fe_sub(Dd, Cc);
  const Fe G = fe_add(Dd, Cc);
  const Fe H = fe_add(A, B);
  R.X = fe_mul(E, F);
  R.Y = fe_mul(G, H);
  R.Z = fe_mul(F, G);
  R.T = fe_mul(E, H);
}

// padd_ext_by with Q in registers.  R may alias P or Q.
__host__ __device__ __forceinline__ void padd_ext(Pt& R, const Pt& P,
                                                  const Pt& Q, const Fe& d) {
  padd_ext_by(R, P, [&](int c) { return coord(Q, c); }, d);
}

// dbl-2008-hwcd doubling, 4M + 4S; T only if with_t (a public choice: the
// ladder asks for it on the last doubling of a window).
__host__ __device__ __forceinline__ void pdbl(Pt& Q, bool with_t) {
  const Fe A = fe_sq(Q.X);
  const Fe B = fe_sq(Q.Y);
  const Fe Zs = fe_sq(Q.Z);
  const Fe Cc = fe_add(Zs, Zs);
  const Fe E = fe_sub(fe_sub(fe_sq(fe_add(Q.X, Q.Y)), A), B);
  const Fe G = fe_sub(B, A);
  const Fe F = fe_sub(G, Cc);
  const Fe H = fe_neg(fe_add(A, B));
  Q.X = fe_mul(E, F);
  Q.Y = fe_mul(G, H);
  Q.Z = fe_mul(F, G);
  if (with_t) Q.T = fe_mul(E, H);
}

// Extended + projective-Niels addition, 8M: Q += e with e = (Y+X, Y-X, Z,
// 2dT) of the point added; unified (identity entries and Q == +-e work).
__host__ __device__ __forceinline__ void madd(Pt& Q, const Pt& e) {
  const Fe PP = fe_mul(fe_add(Q.Y, Q.X), e.X);
  const Fe MM = fe_mul(fe_sub(Q.Y, Q.X), e.Y);
  const Fe TT = fe_mul(Q.T, e.T);
  const Fe ZZ = fe_mul(Q.Z, e.Z);
  const Fe ZZ2 = fe_add(ZZ, ZZ);
  const Fe E = fe_sub(PP, MM);
  const Fe F = fe_sub(ZZ2, TT);
  const Fe G = fe_add(ZZ2, TT);
  const Fe H = fe_add(PP, MM);
  Q.X = fe_mul(E, F);
  Q.Y = fe_mul(G, H);
  Q.Z = fe_mul(F, G);
  Q.T = fe_mul(E, H);
}

// Extended point -> projective-Niels entry (Y+X, Y-X, Z, 2dT); d2 is 2d
// in Montgomery form.  e may alias P.
__host__ __device__ __forceinline__ void to_niels(Pt& e, const Pt& P,
                                                  const Fe& d2) {
  const Fe yx = fe_add(P.Y, P.X);
  const Fe ymx = fe_sub(P.Y, P.X);
  e.T = fe_mul(P.T, d2);
  e.Z = P.Z;
  e.X = yx;
  e.Y = ymx;
}

// k_padd's arithmetic (K5): R = P + Q by padd_ext's formula, term for
// term, for operands given as plain values in [0, p) (from_limbs, without
// to_mont).  A Montgomery product of plain values carries a factor R^-1,
// so E, F, G and H come out as e R^-1, f R^-1, g R^-1, h R^-1 (C takes d
// in Montgomery form to stay on that scale); lifting F and H by R^4 (to f
// R^2, h R^2) makes every coordinate of R = (E F, G H, F G, E H) plain
// again: 12 multiplies, where converting both operands into Montgomery
// form and R out of it takes 22.  ld(o, c) reads coordinate c (X, Y, Z,
// T) of operand o (0: P, 1: Q) as a plain value, each once and in this
// order: X1, X2, Y1, Y2, T1, T2, Z1, Z2 (k_padd gathers them in two
// halves by it).  efgh receives E, F R^2, G, H R^2.
template <class Load>
__host__ __device__ __forceinline__ void padd_plain(const Load& ld,
                                                    const Fe& d,
                                                    Fe (&efgh)[4]) {
  Fe r4;
#pragma unroll
  for (int i = 0; i < NW; ++i) r4.w[i] = ModP::r4(i);
  const Fe X1 = ld(0, 0), X2 = ld(1, 0);
  const Fe A = fe_mul(X1, X2);
  const Fe Y1 = ld(0, 1), Y2 = ld(1, 1);
  const Fe B = fe_mul(Y1, Y2);
  const Fe S = fe_mul(fe_add(X1, Y1), fe_add(X2, Y2));
  efgh[0] = fe_sub(fe_sub(S, A), B);
  efgh[3] = fe_mul(fe_add(A, B), r4);
  const Fe T1 = ld(0, 3), T2 = ld(1, 3);
  const Fe Cc = fe_mul(fe_mul(T1, T2), d);
  const Fe Z1 = ld(0, 2), Z2 = ld(1, 2);
  const Fe Dd = fe_mul(Z1, Z2);
  efgh[1] = fe_mul(fe_sub(Dd, Cc), r4);
  efgh[2] = fe_add(Dd, Cc);
}

// Coordinate c of padd_plain's R, a plain value: (E F, G H, F G, E H).
__host__ __device__ __forceinline__ Fe padd_plain_coord(const Fe (&efgh)[4],
                                                        int c) {
  constexpr int left[4] = {0, 2, 1, 0}, right[4] = {1, 3, 2, 3};
  return fe_mul(efgh[left[c]], efgh[right[c]]);
}

}  // namespace zc32
