// Hopper kernels K1-K6 and K10 (field multiply, power chains, the ladders,
// batched point addition and the fixed-base comb), one thread per lane, and
// a plain C launcher per kernel (bound with ctypes by
// zerocaf_tpu_torch/ops/kernels/build.py).
// Every launcher enqueues on the stream it is given and returns
// cudaGetLastError().
//
// Layout: public tensors are lane-major [n][22] int32 and are read as they
// are (not coalesced; acceptable at this stage).  Per-lane tables live in a
// global scratch buffer that the wrapper allocates, limb-major with the lane
// innermost -- [entry][coord][limb][n] -- so a warp's table reads coalesce.
// Each kernel loops over all windows or digits inside one launch: the TPU's
// split into a table kernel and a per-step kernel existed only for its
// compiler.
//
// Constant time: the ladders read every table entry at every window and
// blend with masks; no load is indexed by a secret digit.  The comb (K6) is
// the exception: it loads the table entry at the secret digit, as the
// reference and the JAX package do (docs/CONSTANT_TIME.md: not oblivious at
// cache-line granularity).

#include <cuda_runtime.h>

#include "field.cuh"
#include "init.cuh"

namespace zc {

constexpr int BLOCK = 128;
constexpr int POW_ENTRIES = 16;        // a^0 .. a^15 (width-4 windows)
constexpr int MAX_SIGNED_WINDOWS = 256;

__device__ __forceinline__ int lane_index() {
  return blockIdx.x * blockDim.x + threadIdx.x;
}

// K1 -- replaces zerocaf_tpu/ops/pallas/field_kernels.py:mul_tiled
// (_mul_kernel / _mul_block).  a * b mod p (spec 0) or mod r (spec 1).
// Bound by integer multiply-adds: one multiply per thread, 264 bytes of
// traffic against ~1100 int32 operations.
__global__ void __launch_bounds__(BLOCK)
    k_mul(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
          int32_t* __restrict__ out, int n, int spec) {
  const int lane = lane_index();
  if (lane >= n) return;
  Fe x, y;
  fe_load(x, a, lane);
  fe_load(y, b, lane);
  fe_mul(x, x, y, spec);
  fe_store(out, lane, x);
}

// K2 -- replaces field_kernels.py:pow_tiled (_pow_table_kernel,
// _pow_step_kernel, _pow_sq_kernel).  a^e for a public exponent given as its
// width-4 digits, most significant first: table a^0..a^15, seed from the
// first digit, then per digit 4 squarings and, for a nonzero digit, one
// multiply by the entry read with a one-hot select over all 16 entries.  The
// digit branch is uniform across threads (the exponent is public).  Bound by
// the ~250 squarings and ~63 multiplies of a 253-bit exponent; the table is
// 1.4 KB per lane in a coalesced [16][22][n] buffer.
__global__ void __launch_bounds__(BLOCK)
    k_pow(const int32_t* __restrict__ a, int32_t* __restrict__ out,
          int32_t* __restrict__ tbl, const int32_t* __restrict__ digits,
          int nwin, int n, int spec) {
  const int lane = lane_index();
  if (lane >= n) return;
  const size_t nn = n;
  const size_t entry = L * nn;
  Fe base, cur;
  fe_load(base, a, lane);
  fe_store_t(tbl, lane, nn, fe_small(1));
  fe_store_t(tbl + entry, lane, nn, base);
  cur = base;
  for (int k = 2; k < POW_ENTRIES; ++k) {
    fe_mul(cur, cur, base, spec);
    fe_store_t(tbl + k * entry, lane, nn, cur);
  }
  Fe r;
  fe_load_t(r, tbl + digits[0] * entry, lane, nn);
  for (int w = 1; w < nwin; ++w) {
    for (int s = 0; s < 4; ++s) fe_sq(r, r, spec);
    const int d = digits[w];
    if (d != 0) {
      Fe e, t;
      fe_load_t(e, tbl, lane, nn);
      for (int k = 1; k < POW_ENTRIES; ++k) {
        fe_load_t(t, tbl + k * entry, lane, nn);
        fe_cmov(e, t, -(int32_t)(d == k));
      }
      fe_mul(r, r, e, spec);
    }
  }
  fe_store(out, lane, r);
}

// K3, K4 and K10 -- replace field_kernels.py:scalar_mul_windowed_stepped
// (_table_kernel, _step_kernel), scalar_mul_windowed_signed
// (_step_kernel_signed, _signed_recode) and scalar_mul_windowed_fused
// (_windowed_kernel: K10 is this kernel with is_signed = 0, entered by its
// own wrapper).  k*P over nwin windows of `width`
// bits, LSB-first in `win` ([n][nwin]).  Unsigned: a 2^width-entry Niels
// table.  Signed: the windows are recoded per lane to digits in
// [-2^(w-1), 2^(w-1)) (the top carry is dropped; it is zero for canonical
// scalars) and the table holds entries 0..2^(w-1); the sign swaps Y+X with
// Y-X and negates 2dT.  Per window, MSB-first: `width` doublings (T only on
// the last), a one-hot read of every entry, one 8M addition.  Bound by
// integer multiply-adds (~40 field multiplies per width-4 window) and by
// register pressure: a point is 88 int32, the accumulator, the entry being
// read and the temporaries of an addition do not fit in 255 registers, so
// they live partly in local memory.
__global__ void __launch_bounds__(BLOCK)
    k_ladder(const int32_t* __restrict__ pts, const int32_t* __restrict__ win,
             int nwin, int width, int is_signed, int32_t* __restrict__ tbl,
             int32_t* __restrict__ out, int n) {
  const int lane = lane_index();
  if (lane >= n) return;
  const size_t nn = n;
  const size_t coord = L * nn;
  const size_t entry = 4 * coord;
  const size_t plane = L * nn;         // one coordinate of [4][n][22]
  const int nb = is_signed ? (1 << (width - 1)) + 1 : 1 << width;

  Pt P;
  fe_load(P.X, pts, lane);
  fe_load(P.Y, pts + plane, lane);
  fe_load(P.Z, pts + 2 * plane, lane);
  fe_load(P.T, pts + 3 * plane, lane);

  // table: entry 0 the Niels identity (1, 1, 1, 0), entry k = k*P
  {
    const Fe one = fe_small(1);
    fe_store_t(tbl, lane, nn, one);
    fe_store_t(tbl + coord, lane, nn, one);
    fe_store_t(tbl + 2 * coord, lane, nn, one);
    fe_store_t(tbl + 3 * coord, lane, nn, fe_small(0));
    Pt acc = P, e;
    for (int k = 1; k < nb; ++k) {
      if (k > 1) padd_ext(acc, acc, P);
      to_niels(e, acc);
      int32_t* t = tbl + k * entry;
      fe_store_t(t, lane, nn, e.X);
      fe_store_t(t + coord, lane, nn, e.Y);
      fe_store_t(t + 2 * coord, lane, nn, e.Z);
      fe_store_t(t + 3 * coord, lane, nn, e.T);
    }
  }

  const int32_t* wl = win + (size_t)lane * nwin;
  signed char sd[MAX_SIGNED_WINDOWS];
  if (is_signed) {
    const int h = 1 << (width - 1), full = 1 << width;
    int carry = 0;
    for (int w = 0; w < nwin; ++w) {
      const int d = wl[w] + carry;
      const int neg = d >= h;
      sd[w] = (signed char)(d - neg * full);
      carry = neg;
    }
  }

  Pt Q;
  Q.X = fe_small(0);
  Q.Y = fe_small(1);
  Q.Z = fe_small(1);
  Q.T = fe_small(0);
  for (int i = nwin - 1; i >= 0; --i) {
    for (int j = 0; j < width; ++j) pdbl(Q, j == width - 1);
    const int d = is_signed ? sd[i] : wl[i];
    const int32_t s = -(int32_t)(d < 0);
    const int a = (d ^ s) - s;
    Pt e, t;
    fe_load_t(e.X, tbl, lane, nn);
    fe_load_t(e.Y, tbl + coord, lane, nn);
    fe_load_t(e.Z, tbl + 2 * coord, lane, nn);
    fe_load_t(e.T, tbl + 3 * coord, lane, nn);
    for (int k = 1; k < nb; ++k) {
      const int32_t m = -(int32_t)(a == k);
      const int32_t* te = tbl + k * entry;
      fe_load_t(t.X, te, lane, nn);
      fe_load_t(t.Y, te + coord, lane, nn);
      fe_load_t(t.Z, te + 2 * coord, lane, nn);
      fe_load_t(t.T, te + 3 * coord, lane, nn);
      fe_cmov(e.X, t.X, m);
      fe_cmov(e.Y, t.Y, m);
      fe_cmov(e.Z, t.Z, m);
      fe_cmov(e.T, t.T, m);
    }
    // sign: swap Y+X / Y-X and negate 2dT where s == -1 (a no-op for
    // unsigned windows, which are never negative)
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int32_t p = e.X.v[k], q = e.Y.v[k];
      e.X.v[k] = (q & s) | (p & ~s);
      e.Y.v[k] = (p & s) | (q & ~s);
      e.T.v[k] = (e.T.v[k] ^ s) - s;
    }
    madd(Q, e);
  }
  fe_store(out, lane, Q.X);
  fe_store(out + plane, lane, Q.Y);
  fe_store(out + 2 * plane, lane, Q.Z);
  fe_store(out + 3 * plane, lane, Q.T);
}

// One operand of k_padd: its four coordinates, each a strided view
// [outer][inner][22] (limbs contiguous) with the element strides (so, si)
// shared by the four.  Lane l is element (l / inner, l % inner).
struct PaddIn {
  const int32_t* c[4];
  int so, si;
};

__device__ __forceinline__ void padd_in_load(Pt& P, const PaddIn& in,
                                             int lane, int inner) {
  const int o = lane / inner;
  const size_t off = (size_t)o * in.so + (size_t)(lane - o * inner) * in.si;
  fe_load(P.X, in.c[0] + off, 0);
  fe_load(P.Y, in.c[1] + off, 0);
  fe_load(P.Z, in.c[2] + off, 0);
  fe_load(P.T, in.c[3] + off, 0);
}

// K5 -- replaces field_kernels.py:padd_tiled (_padd_kernel).  Batched
// unified extended addition R = P + Q: one thread per lane runs padd_ext,
// 10 field multiplies.  The operands are read where they lie -- the MSM's
// lane reduction passes halves of its per-lane tables, strided views that
// would otherwise be copied first -- and R is written as coordinate planes
// [4][n][22].  Bound by integer multiply-adds (about 9,900 per lane against
// 1056 bytes of traffic); the TPU's padding to 1024-lane blocks has no
// counterpart.
__global__ void __launch_bounds__(BLOCK)
    k_padd(const PaddIn p, const PaddIn q, int32_t* __restrict__ out, int n,
           int inner) {
  const int lane = lane_index();
  if (lane >= n) return;
  const size_t plane = L * (size_t)n;
  Pt P, Q;
  padd_in_load(P, p, lane, inner);
  padd_in_load(Q, q, lane, inner);
  padd_ext(P, P, Q);
  fe_store(out, lane, P.X);
  fe_store(out + plane, lane, P.Y);
  fe_store(out + 2 * plane, lane, P.Z);
  fe_store(out + 3 * plane, lane, P.T);
}

// K6 -- replaces field_kernels.py:fixed_base_mul_stepped (_madd_affine_kernel,
// _madd_packed_core, _madd_affine_packed_kernel, _madd2_affine_packed_kernel
// and the XLA gather glue of its five variants).  B*k over nwin windows of
// `width` bits, LSB-first in `win` ([n][nwin]): per window, LSB first, the
// entry at the digit is loaded from the shared comb table and added with
// one 7M mixed addition; no doublings.  Signed: the digits are recoded on
// the way up (digit + carry, minus 2^width at or above 2^(width-1)), the
// entry at |d| is loaded and the sign swaps y+x with y-x and negates 2dxy.
// Digits are taken mod 2^width, so every load is inside the table.
//
// The table is [nwin][nent][words] int32 in one of two layouts: rows (the
// three coordinates' 22 limbs, words = 68) or packed (limb i | limb i+11 <<
// 12, words = 36; COMB_WORDS in field_kernels.py); both pad an entry to a multiple of 16 bytes, so it
// arrives in 16-byte loads.  The load is indexed by the secret digit (not
// oblivious at cache-line granularity, as in the reference).  One thread
// runs all windows of its lane in one launch with Q in registers; the TPU
// ran one program per window pair with Q through HBM between them.  Bound
// by integer multiply-adds (7 field multiplies a window, 126 a lane at
// width 14): the table entries are 272 or 144 bytes a window a lane from
// an 18-40 MB table that mostly stays in the 50 MB L2.
constexpr int ROWS_WORDS = 68;
constexpr int PACKED_WORDS = 36;

template <int WORDS>
__device__ __forceinline__ void comb_load(int32_t (&buf)[WORDS],
                                          const int32_t* entry) {
  const int4* src = reinterpret_cast<const int4*>(entry);
#pragma unroll
  for (int k = 0; k < WORDS / 4; ++k) {
    const int4 v = __ldg(src + k);
    buf[4 * k] = v.x;
    buf[4 * k + 1] = v.y;
    buf[4 * k + 2] = v.z;
    buf[4 * k + 3] = v.w;
  }
}

__device__ __forceinline__ void comb_entry(Fe (&e)[3], const int32_t* entry,
                                           int packed) {
  if (packed) {
    int32_t buf[PACKED_WORDS];
    comb_load(buf, entry);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int k = 0; k < 11; ++k) {
        e[j].v[k] = buf[11 * j + k] & MASK;
        e[j].v[k + 11] = buf[11 * j + k] >> W;
      }
    }
  } else {
    int32_t buf[ROWS_WORDS];
    comb_load(buf, entry);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int k = 0; k < L; ++k) e[j].v[k] = buf[L * j + k];
    }
  }
}

__global__ void __launch_bounds__(BLOCK)
    k_comb(const int32_t* __restrict__ tbl, const int32_t* __restrict__ win,
           int nwin, int width, int is_signed, int nent, int packed,
           int32_t* __restrict__ out, int n) {
  const int lane = lane_index();
  if (lane >= n) return;
  const int32_t* wl = win + (size_t)lane * nwin;
  const int h = 1 << (width - 1), full = 1 << width;
  const int words = packed ? PACKED_WORDS : ROWS_WORDS;
  Pt Q;
  Q.X = fe_small(0);
  Q.Y = fe_small(1);
  Q.Z = fe_small(1);
  Q.T = fe_small(0);
  int carry = 0;
  for (int w = 0; w < nwin; ++w) {
    int d = wl[w] & (full - 1);
    if (is_signed) {
      d += carry;
      carry = d >= h;
      d -= carry * full;
    }
    const int32_t s = -(int32_t)(d < 0);
    const int a = (d ^ s) - s;
    Fe e[3];
    comb_entry(e, tbl + ((size_t)w * nent + a) * words, packed);
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int32_t p = e[0].v[k], q = e[1].v[k];
      e[0].v[k] = (q & s) | (p & ~s);
      e[1].v[k] = (p & s) | (q & ~s);
      e[2].v[k] = (e[2].v[k] ^ s) - s;
    }
    madd_affine(Q, e[0], e[1], e[2]);
  }
  const size_t plane = L * (size_t)n;
  fe_store(out, lane, Q.X);
  fe_store(out + plane, lane, Q.Y);
  fe_store(out + 2 * plane, lane, Q.Z);
  fe_store(out + 3 * plane, lane, Q.T);
}

inline int blocks_for(int n) { return (n + BLOCK - 1) / BLOCK; }

}  // namespace zc

// ---- launchers (plain C interface) ----------------------------------------

extern "C" {

int zc_mul(const int32_t* a, const int32_t* b, int32_t* out, int n, int spec,
           void* stream) {
  zc::k_mul<<<zc::blocks_for(n), zc::BLOCK, 0,
              static_cast<cudaStream_t>(stream)>>>(a, b, out, n, spec);
  return static_cast<int>(cudaGetLastError());
}

int zc_pow(const int32_t* a, int32_t* out, int32_t* tbl, const int32_t* digits,
           int nwin, int n, int spec, void* stream) {
  zc::k_pow<<<zc::blocks_for(n), zc::BLOCK, 0,
              static_cast<cudaStream_t>(stream)>>>(a, out, tbl, digits, nwin,
                                                   n, spec);
  return static_cast<int>(cudaGetLastError());
}

int zc_ladder(const int32_t* pts, const int32_t* win, int nwin, int width,
              int is_signed, int32_t* tbl, int32_t* out, int n, void* stream) {
  zc::k_ladder<<<zc::blocks_for(n), zc::BLOCK, 0,
                 static_cast<cudaStream_t>(stream)>>>(pts, win, nwin, width,
                                                      is_signed, tbl, out, n);
  return static_cast<int>(cudaGetLastError());
}

// p0..p3 and q0..q3: the coordinates of the two operands, each with its
// (outer, inner) element strides; n lanes, `inner` of them per outer row.
int zc_padd(const int32_t* p0, const int32_t* p1, const int32_t* p2,
            const int32_t* p3, int p_so, int p_si, const int32_t* q0,
            const int32_t* q1, const int32_t* q2, const int32_t* q3, int q_so,
            int q_si, int32_t* out, int n, int inner, void* stream) {
  const zc::PaddIn p = {{p0, p1, p2, p3}, p_so, p_si};
  const zc::PaddIn q = {{q0, q1, q2, q3}, q_so, q_si};
  zc::k_padd<<<zc::blocks_for(n), zc::BLOCK, 0,
               static_cast<cudaStream_t>(stream)>>>(p, q, out, n, inner);
  return static_cast<int>(cudaGetLastError());
}

// tbl: [nwin][nent][words] comb table, rows (words 68) or packed (words
// 36); win: [n][nwin] digits; out: [4][n][22].
int zc_comb(const int32_t* tbl, const int32_t* win, int nwin, int width,
            int is_signed, int nent, int packed, int32_t* out, int n,
            void* stream) {
  zc::k_comb<<<zc::blocks_for(n), zc::BLOCK, 0,
               static_cast<cudaStream_t>(stream)>>>(tbl, win, nwin, width,
                                                    is_signed, nent, packed,
                                                    out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
