// Hopper kernels K1-K6 and K10 (field multiply, power chains, the ladders,
// batched point addition and the fixed-base comb), one thread per lane, and
// a plain C launcher per kernel (bound with ctypes by
// zerocaf_tpu_torch/ops/kernels/build.py).
// Every launcher enqueues on the stream it is given and returns
// cudaGetLastError().
//
// Two field cores.  k_pow (K2), k_padd (K5) and k_ladder (K3, K4, K10)
// compute on the 8 x 32-bit Montgomery core of field32.cuh (pow32.cuh and
// ladder32.cuh hold the per-lane bodies of k_pow and k_ladder): they
// convert their 22 x 12-bit inputs at entry, and write canonical limbs,
// equal to their plain versions' results after canonicalization.  k_mul
// and k_comb keep the 22 x 12-bit limbs of field.cuh and agree with their
// plain versions limb for limb.
//
// Layout: public tensors are lane-major [n][22] int32.  k_ladder's per-lane
// tables live in a global scratch buffer that the wrapper allocates, lane
// innermost ([entry][16-byte piece][n]), so a warp's table reads coalesce;
// k_pow's live in shared memory.  Each kernel loops over all windows or
// digits inside one launch: the TPU's split into a table kernel and a
// per-step kernel existed only for its compiler.
//
// Constant time: the ladders read every table entry at every window and
// blend with masks; no load is indexed by a secret digit.  Power chains:
// the access pattern depends only on the public exponent (k_pow reads the
// entry at each public digit).  The comb (K6) is the exception: it loads
// the table entry at the secret digit, as the reference and the JAX
// package do (docs/CONSTANT_TIME.md: not oblivious at cache-line
// granularity).

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"
#include "field32.cuh"
#include "init.cuh"
#include "ladder32.cuh"
#include "pow32.cuh"

namespace zc {

constexpr int BLOCK = 128;
constexpr int CORE_MIN_BLOCKS = 4;     // k_padd's and k_ladder's blocks per SM
constexpr int WARP = 32;
constexpr int POW_BLOCK = 64;          // k_pow: 30,720 B of table a block

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

// 22 x 12-bit limbs of lane `lane` in a lane-major [n][22] plane -> the
// core's Montgomery form (mod M), and canonical limbs back.
template <class M = zc32::ModP>
__device__ __forceinline__ zc32::Fe core_load(const int32_t* base,
                                              size_t lane) {
  int32_t x[L];
#pragma unroll
  for (int k = 0; k < L; ++k) x[k] = base[lane * L + k];
  return zc32::to_mont<M>(zc32::from_limbs<M>(x));
}

template <class M = zc32::ModP>
__device__ __forceinline__ void core_store(int32_t* base, size_t lane,
                                           const zc32::Fe& a) {
  int32_t x[L];
  zc32::to_limbs<M>(a, x);
#pragma unroll
  for (int k = 0; k < L; ++k) base[lane * L + k] = x[k];
}

// k_pow's table of one thread in dynamic shared memory, [entry][word]
// [thread]: a warp's reads of one word fall in 32 different banks.
struct PowTable {
  uint32_t* base;                      // the block's table + threadIdx.x
  int stride;                          // threads a block
  __device__ zc32::Fe get(int k) const {
    zc32::Fe r;
#pragma unroll
    for (int i = 0; i < zc32::NW; ++i)
      r.w[i] = base[((k - 1) * zc32::NW + i) * stride];
    return r;
  }
  __device__ void put(int k, const zc32::Fe& v) const {
#pragma unroll
    for (int i = 0; i < zc32::NW; ++i)
      base[((k - 1) * zc32::NW + i) * stride] = v.w[i];
  }
};

constexpr int POW_TABLE_WORDS = (zc32::POW_ENTRIES - 1) * zc32::NW;

// K2 -- replaces field_kernels.py:pow_tiled (_pow_table_kernel,
// _pow_step_kernel, _pow_sq_kernel).  a^e mod p (M = ModP, spec 0) or mod r
// (ModR, spec 1) for a public exponent given as its width-4 digits, most
// significant first, on the 8 x 32-bit core: zc32::pow_lane (pow32.cuh),
// the chain of the TPU kernel and the plain version, one thread a lane.
// The input is signed lazy 22 x 12 limbs, the output canonical limbs.
//
// The table a^1..a^15 (480 bytes a lane) lives in dynamic shared memory,
// 30,720 bytes for a block of 64 threads: seven blocks an SM.  (128
// threads, 61,440 bytes and three blocks an SM, ran 1.7 % slower at 2^20
// lanes and as fast at 32768 on an H100: chip_variants.py, PERF.md; the
// launcher opts in to the shared memory above 48 KB that such a block
// needs.)  A nonzero digit reads the one entry at that digit, uniform
// across the block: the digits are the public exponent's.  The TPU's
// one-hot select over all 16 entries was its stand-in for a dynamic
// slice; the 22 x 12 kernel before this one kept it, over a global
// [16][22][n] scratch table, 1.48 GB at 2^20 lanes.
//
// Bound by the multiplies: e = (p-5)/8 takes 14 multiplies for the table,
// 248 squares (fe_sq_sos, 36 word products and the reduction) and 62
// multiplies (a rolled loop of 8 steps).  At 2^20 lanes (Engine.msm's
// decode) the card is full and their issue rate bounds it; at 32768 lanes,
// four blocks an SM, the chain's latency does.
template <class M>
__global__ void __launch_bounds__(POW_BLOCK)
    k_pow(const int32_t* __restrict__ a, int32_t* __restrict__ out,
          const int32_t* __restrict__ digits, int nwin, int n) {
  extern __shared__ uint32_t pow_tbl[];
  const int lane = lane_index();
  if (lane >= n) return;
  const PowTable t = {pow_tbl + threadIdx.x, (int)blockDim.x};
  const zc32::Fe r = zc32::pow_lane<M>(
      core_load<M>(a, lane), [&](int w) { return __ldg(digits + w); }, nwin, t);
  core_store<M>(out, lane, r);
}

// One lane's table in k_ladder's scratch buffer [entry][q][n][4]: the
// 16-byte quarter q of an entry, lane innermost, so a warp's 16-byte reads
// coalesce.
struct LaneTable {
  uint4* base;                         // the buffer + lane
  size_t n;
  __host__ __device__ void get(int entry, int q, uint32_t (&v)[4]) const {
    const uint4 x = base[((size_t)entry * (zc32::NIELS_WORDS / 4) + q) * n];
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
  __host__ __device__ void put(int entry, int q, const uint32_t (&v)[4]) const {
    base[((size_t)entry * (zc32::NIELS_WORDS / 4) + q) * n] =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
};

// K3, K4 and K10 -- replace field_kernels.py:scalar_mul_windowed_stepped
// (_table_kernel, _step_kernel), scalar_mul_windowed_signed
// (_step_kernel_signed, _signed_recode) and scalar_mul_windowed_fused
// (_windowed_kernel: K10 is this kernel with is_signed = 0, entered by its
// own wrapper).  k*P over nwin windows of `width` bits, LSB-first in `win`
// ([n][nwin]), one thread a lane: zc32::ladder_lane (ladder32.cuh) on the
// 8 x 32-bit core -- a per-lane Niels table of 2^width entries (unsigned)
// or 2^(w-1)+1 (signed, recoded in the kernel with the top carry
// dropped), then per window `width` doublings, a masked read of every
// entry and one 8M addition.  P arrives as signed lazy 22 x 12 limbs
// ([4][n][22]) and Q leaves as canonical limbs.
//
// Bound by integer multiply-adds: a width-4 window is 16 squares and 21
// multiplies, 104 word products a multiply and 76 a square (K4 at 32768
// lanes: 0.44 ms).  The core squares by its multiply, and a multiply is a
// rolled loop of 8 steps of some 68 instructions, so K4's multiplies alone
// take 1.3 ms at the card's issue rate.  At 32768 lanes a card holds two
// blocks an SM, two warps a scheduler: too few to hide the multiplies'
// dependent carry chains, and the kernel runs near 45 % of that rate
// (PERF.md).  An entry is 32 words (128 bytes; 88 int32 on the 22 x 12
// limbs), so a point is 32 registers: the accumulator, the entry being
// selected and a multiply's temporaries fit __launch_bounds__(128, 4)'s
// 128 registers with no spill.  The table, 4 KB a lane at most, stays in
// device memory and mostly in L2 (K4 at 32768 lanes: 37.7 MB).  The
// recode's sd[] is local memory: one byte a window.
__global__ void __launch_bounds__(BLOCK, CORE_MIN_BLOCKS)
    k_ladder(const int32_t* __restrict__ pts, const int32_t* __restrict__ win,
             int nwin, int width, int is_signed, uint32_t* __restrict__ tbl,
             int32_t* __restrict__ out, int n) {
  const int lane = lane_index();
  if (lane >= n) return;
  const size_t plane = L * (size_t)n;  // one coordinate of [4][n][22]
  zc32::Pt P, Q;
  P.X = core_load(pts, lane);
  P.Y = core_load(pts + plane, lane);
  P.Z = core_load(pts + 2 * plane, lane);
  P.T = core_load(pts + 3 * plane, lane);
  const LaneTable t = {reinterpret_cast<uint4*>(tbl) + lane, (size_t)n};
  const int32_t* wl = win + (size_t)lane * nwin;
  zc32::ladder_lane(Q, P, [&](int i) { return wl[i]; }, nwin, width,
                    is_signed, t, zc32::c_d32, zc32::c_d2_32);
  core_store(out, lane, Q.X);
  core_store(out + plane, lane, Q.Y);
  core_store(out + 2 * plane, lane, Q.Z);
  core_store(out + 3 * plane, lane, Q.T);
}

// One operand of k_padd: its four coordinates, each a strided view
// [outer][inner][22] (limbs contiguous) with the element strides (so, si)
// shared by the four.  Lane l is element (l / inner, l % inner).
struct PaddIn {
  const int32_t* c[4];
  int so, si;
};

// How k_padd reads its operands, chosen by the launcher from the pointers
// and strides: in 8-byte pieces where every coordinate pointer and both
// strides are 8-byte aligned (the lane reduction's table halves, the
// scan's column views, any contiguous planes), else in 4-byte pieces.
enum PaddRead { READ_WORDS = 1, READ_PAIRS = 2 };

// Element offset of lane `lane` in an operand (the same for its four
// coordinates).
__device__ __forceinline__ size_t padd_offset(const PaddIn& in, int lane,
                                              int inner) {
  const int o = lane / inner;
  return (size_t)o * in.so + (size_t)(lane - o * inner) * in.si;
}

// Coordinate c of the element at `off`, as a plain value in [0, p)
// (zc32::padd_plain's operands).
template <int MODE>
__device__ __forceinline__ zc32::Fe padd_coord(const PaddIn& in, size_t off,
                                               int c) {
  const int32_t* src = in.c[c] + off;
  int32_t y[L];
  if (MODE == READ_PAIRS) {
#pragma unroll
    for (int k = 0; k < L / 2; ++k) {
      const int2 v = __ldg(reinterpret_cast<const int2*>(src) + k);
      y[2 * k] = v.x;
      y[2 * k + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < L; ++k) y[k] = __ldg(src + k);
  }
  return zc32::from_limbs(y);
}

// K5 -- replaces field_kernels.py:padd_tiled (_padd_kernel).  Batched
// unified extended addition R = P + Q, one thread a lane, on the 8 x 32-bit
// core: zc32::padd_plain, padd_ext's formula term for term (so the same
// field values) on plain values, 12 multiplies (field32.cuh says why not
// 22).  Each operand coordinate is read where the formula first needs it
// and each coordinate of R is written as soon as it is computed, as
// canonical limbs (pack_limbs) into coordinate planes [4][n][22]: with at
// most four field elements and one conversion live at a time the kernel
// fits 128 registers.  The operands are read where they lie -- the MSM's
// lane reduction passes halves of its per-lane tables, strided views that
// would otherwise be copied first -- in 8- or 4-byte pieces (PaddRead).
// Each warp stages its 32 results of one coordinate in shared memory and
// writes them as one contiguous run of 8-byte stores.
//
// Bound by bytes: 1056 a lane (two points read, one written) against 12
// field multiplies, 1,248 word products; at the lane reduction's first
// round at 2^20 (2,973,696 lanes) 0.94 ms of memory against 0.60 ms to
// issue the multiplies' rolled loops.  It runs at 1.8 x the byte bound
// (PERF.md).  The TPU's padding to 1024-lane blocks has no
// counterpart.
template <int MODE>
__global__ void __launch_bounds__(BLOCK, CORE_MIN_BLOCKS)
    k_padd(const PaddIn p, const PaddIn q, int32_t* __restrict__ out, int n,
           int inner) {
  __shared__ __align__(16) int32_t stage[BLOCK / WARP][WARP * L];
  const int lane = lane_index();
  const int t = threadIdx.x % WARP;
  const int first = lane - t;          // the warp's first lane
  if (first >= n) return;              // the whole warp: no __syncwarp waits
  const int count = min(WARP, n - first);
  const bool live = lane < n;
  zc32::Fe efgh[4];
  if (live) {
    const size_t po = padd_offset(p, lane, inner);
    const size_t qo = padd_offset(q, lane, inner);
    zc32::padd_plain([&](int o, int c) {
      return o ? padd_coord<MODE>(q, qo, c) : padd_coord<MODE>(p, po, c);
    }, zc32::c_d32, efgh);
  }
  int32_t* rows = stage[threadIdx.x / WARP];
  const size_t plane = L * (size_t)n;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (live) {
      int32_t x[L];
      zc32::pack_limbs(zc32::padd_plain_coord(efgh, c), x);
#pragma unroll
      for (int k = 0; k < L / 2; ++k)
        reinterpret_cast<int2*>(rows + t * L)[k] = make_int2(x[2 * k], x[2 * k + 1]);
    }
    __syncwarp();
    // the warp's lanes are contiguous in the plane: count * 88 bytes, from
    // an 8-byte aligned start (88 bytes a lane)
    int2* dst = reinterpret_cast<int2*>(out + c * plane + (size_t)first * L);
    const int2* src = reinterpret_cast<const int2*>(rows);
    for (int i = t; i < count * (L / 2); i += WARP) dst[i] = src[i];
    __syncwarp();
  }
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

// True where k_padd may read an operand in 8-byte pieces.
inline bool padd_pairs(const PaddIn& in) {
  bool pairs = in.so % 2 == 0 && in.si % 2 == 0;
  for (int c = 0; c < 4; ++c)
    pairs = pairs && reinterpret_cast<uintptr_t>(in.c[c]) % 8 == 0;
  return pairs;
}

}  // namespace zc

// ---- launchers (plain C interface) ----------------------------------------

extern "C" {

int zc_mul(const int32_t* a, const int32_t* b, int32_t* out, int n, int spec,
           void* stream) {
  zc::k_mul<<<zc::blocks_for(n), zc::BLOCK, 0,
              static_cast<cudaStream_t>(stream)>>>(a, b, out, n, spec);
  return static_cast<int>(cudaGetLastError());
}

int zc_pow(const int32_t* a, int32_t* out, const int32_t* digits, int nwin,
           int n, int spec, void* stream) {
  void (*kernel)(const int32_t*, int32_t*, const int32_t*, int, int) =
      spec ? zc::k_pow<zc32::ModR> : zc::k_pow<zc32::ModP>;
  const int smem = zc::POW_BLOCK * zc::POW_TABLE_WORDS * sizeof(uint32_t);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(n + zc::POW_BLOCK - 1) / zc::POW_BLOCK, zc::POW_BLOCK, smem,
           static_cast<cudaStream_t>(stream)>>>(a, out, digits, nwin, n);
  return static_cast<int>(cudaGetLastError());
}

// tbl: scratch of nb x 32 x n words, nb the table's entries.
int zc_ladder(const int32_t* pts, const int32_t* win, int nwin, int width,
              int is_signed, int32_t* tbl, int32_t* out, int n, void* stream) {
  zc::k_ladder<<<zc::blocks_for(n), zc::BLOCK, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      pts, win, nwin, width, is_signed, reinterpret_cast<uint32_t*>(tbl), out,
      n);
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
  const auto s = static_cast<cudaStream_t>(stream);
  const int blocks = zc::blocks_for(n);
  if (zc::padd_pairs(p) && zc::padd_pairs(q))
    zc::k_padd<zc::READ_PAIRS><<<blocks, zc::BLOCK, 0, s>>>(p, q, out, n, inner);
  else
    zc::k_padd<zc::READ_WORDS><<<blocks, zc::BLOCK, 0, s>>>(p, q, out, n, inner);
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
