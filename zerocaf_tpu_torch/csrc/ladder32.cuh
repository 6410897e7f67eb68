// The per-lane body of k_ladder (K3, K4 and K10; csrc/field_kernels.cu) on
// the 8 x 32-bit core of field32.cuh: k*P by fixed windows over a per-lane
// table of projective-Niels entries, read obliviously.
//
// The body is a template over the lane's table, an accessor with
//   void get(int entry, int q, uint32_t (&v)[4]) const;
//   void put(int entry, int q, const uint32_t (&v)[4]) const;
// for the 16-byte quarter q (0..7) of an entry's 32 words (Y+X, Y-X, Z,
// 2dT, 8 words each).  The kernel's accessor addresses a global scratch
// buffer laid out [entry][q][lane][4], so a warp's 16-byte reads coalesce;
// tests/test_torch_field32_host.py compiles this header for the host with
// an array per lane and holds the body against the port's plain versions
// and the oracle.
//
// Constant time: every entry is read at every window and selected by mask;
// no load and no branch depends on a digit.  The branches that remain
// (the window and doubling loops, is_signed, with_t) follow public values.

#pragma once

#include "field32.cuh"

namespace zc32 {

constexpr int NIELS_WORDS = 4 * NW;            // words of one table entry
constexpr int MAX_SIGNED_WINDOWS = 256;

template <class Tbl>
__host__ __device__ __forceinline__ void put_entry(const Tbl& tbl, int k,
                                                   Pt& e) {
#pragma unroll
  for (int q = 0; q < NIELS_WORDS / 4; ++q) {
    const uint32_t v[4] = {pt_word(e, 4 * q), pt_word(e, 4 * q + 1),
                           pt_word(e, 4 * q + 2), pt_word(e, 4 * q + 3)};
    tbl.put(k, q, v);
  }
}

// Coordinate c (words 8c..8c+7) of entry k.
template <class Tbl>
__host__ __device__ __forceinline__ Fe get_coord(const Tbl& tbl, int k, int c) {
  uint32_t lo[4], hi[4];
  tbl.get(k, 2 * c, lo);
  tbl.get(k, 2 * c + 1, hi);
  Fe r;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    r.w[j] = lo[j];
    r.w[4 + j] = hi[j];
  }
  return r;
}

// r = v where the mask m is all ones, else r unchanged.
__host__ __device__ __forceinline__ void fe_blend(Fe& r, const Fe& v,
                                                  uint32_t m) {
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = (v.w[i] & m) | (r.w[i] & ~m);
}

// Entry a (0 <= a < nb), read obliviously: every entry is loaded and the
// one at a kept by mask.
template <class Tbl>
__host__ __device__ __forceinline__ void select_entry(Pt& e, const Tbl& tbl,
                                                      int nb, int a) {
#pragma unroll
  for (int q = 0; q < NIELS_WORDS / 4; ++q) {
    uint32_t v[4];
    tbl.get(0, q, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) pt_word(e, 4 * q + j) = v[j];
  }
#pragma unroll 1
  for (int k = 1; k < nb; ++k) {
    const uint32_t m = 0u - (uint32_t)(a == k);
#pragma unroll
    for (int q = 0; q < NIELS_WORDS / 4; ++q) {
      uint32_t v[4];
      tbl.get(k, q, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t& w = pt_word(e, 4 * q + j);
        w = (v[j] & m) | (w & ~m);
      }
    }
  }
}

// Q = k*P over nwin windows of `width` bits, least significant first:
// wl(i) is window i.  Unsigned: entries 0..2^width - 1.  Signed: the windows are
// recoded to digits in [-2^(w-1), 2^(w-1)) -- the top carry is dropped, as
// the JAX package's _signed_recode does; it is zero for canonical scalars
// -- and the table holds entries 0..2^(w-1), the sign applied by swapping
// Y+X with Y-X and negating 2dT.  Per window, most significant first:
// `width` doublings (T only on the last), a masked read of every entry,
// one 8M addition.  P and Q in Montgomery form; d and d2 are d and 2d.
template <class Win, class Tbl>
__host__ __device__ __forceinline__ void ladder_lane(
    Pt& Q, const Pt& P, const Win& wl, int nwin, int width, int is_signed,
    const Tbl& tbl, const Fe& d, const Fe& d2) {
  const int nb = is_signed ? (1 << (width - 1)) + 1 : 1 << width;

  // table: entry k = k*P, entry 0 the Niels identity (1, 1, 1, 0).  P is
  // parked in entry 0's slot while the others are built and read back a
  // coordinate at a time, so only the running sum stays in registers.
  {
    Pt acc = P, e;
    put_entry(tbl, 0, acc);
#pragma unroll 1
    for (int k = 1; k < nb; ++k) {
      if (k > 1)
        padd_ext_by(acc, acc, [&](int c) { return get_coord(tbl, 0, c); }, d);
      to_niels(e, acc, d2);
      put_entry(tbl, k, e);
    }
    e.X = fe_one();
    e.Y = fe_one();
    e.Z = fe_one();
    e.T = fe_zero();
    put_entry(tbl, 0, e);
  }

  signed char sd[MAX_SIGNED_WINDOWS];
  if (is_signed) {
    const int h = 1 << (width - 1), full = 1 << width;
    int carry = 0;
    for (int w = 0; w < nwin; ++w) {
      const int dg = wl(w) + carry;
      const int neg = dg >= h;
      sd[w] = (signed char)(dg - neg * full);
      carry = neg;
    }
  }

  Q.X = fe_zero();
  Q.Y = fe_one();
  Q.Z = fe_one();
  Q.T = fe_zero();
  for (int i = nwin - 1; i >= 0; --i) {
#pragma unroll 1
    for (int j = 0; j < width; ++j) pdbl(Q, j == width - 1);
    const int dg = is_signed ? sd[i] : wl(i);
    const uint32_t s = 0u - (uint32_t)(dg < 0);          // all ones if negative
    const int a = (dg ^ (int)s) - (int)s;                // |dg|
    // the sign swaps Y+X with Y-X and negates 2dT where s is all ones (a
    // no-op for unsigned windows, which are never negative)
    Pt e;
    select_entry(e, tbl, nb, a);
    const Fe x = e.X;
    fe_blend(e.X, e.Y, s);
    fe_blend(e.Y, x, s);
    fe_blend(e.T, fe_neg(e.T), s);
    madd(Q, e);
  }
}

}  // namespace zc32
