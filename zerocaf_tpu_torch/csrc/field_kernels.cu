// Hopper kernels K1-K6 and K10 (field multiply, power chains, the ladders,
// batched point addition and the fixed-base comb), k_canonical (the limb
// engine's observation boundary), and a plain C launcher per kernel (bound
// with ctypes by zerocaf_tpu_torch/ops/kernels/build.py).
// Every launcher enqueues on the stream it is given and returns
// cudaGetLastError().
//
// One field core: every kernel computes on the 8 x 32-bit Montgomery core
// of field32.cuh (pow32.cuh, ladder32.cuh and comb32.cuh hold the per-lane
// bodies of k_pow, k_ladder and k_comb).  The kernels convert their
// 22 x 12-bit inputs at entry and write canonical limbs, equal to their
// plain versions' results after canonicalization.
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

#include "canon32.cuh"
#include "comb32.cuh"
#include "field32.cuh"
#include "init.cuh"
#include "ladder32.cuh"
#include "pow32.cuh"

namespace zc {

constexpr int L = zc32::NL;            // limbs of a 22 x 12-bit element
constexpr int BLOCK = 128;
constexpr int CORE_MIN_BLOCKS = 4;     // k_padd's and k_ladder's blocks per SM
constexpr int WARP = 32;
constexpr int POW_BLOCK = 64;          // k_pow: 30,720 B of table a block
constexpr int COMB_CORE_WORDS = 3 * zc32::NW;   // k_comb: words of an entry

__device__ __forceinline__ int lane_index() {
  return blockIdx.x * blockDim.x + threadIdx.x;
}

// A block's contiguous tile of `words` int32 between device and shared
// memory, the block's threads striding over it: in 16-byte pieces where
// both ends are 16-byte aligned (VEC), else word by word (still
// coalesced), then the words past the last full piece.
template <bool VEC>
__device__ __forceinline__ void tile_copy(int32_t* __restrict__ dst,
                                          const int32_t* __restrict__ src,
                                          int words) {
  int done = 0;
  if (VEC) {
    done = words & ~3;
    for (int i = threadIdx.x; i < words / 4; i += blockDim.x)
      reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
  }
  for (int i = done + threadIdx.x; i < words; i += blockDim.x) dst[i] = src[i];
}

// K1 -- replaces zerocaf_tpu/ops/pallas/field_kernels.py:mul_tiled
// (_mul_kernel / _mul_block).  a * b mod p (M = ModP) or mod r (ModR) on
// the 8 x 32-bit core: zc32::mul_limbs, a Montgomery product of the plain
// a and b R (two multiplies), written as canonical limbs, which meet the
// wrapper's contract (semi limbs out) as they are.  The inputs are signed
// lazy limbs, at most one add deep.
//
// Bound by bytes: 264 a lane (a and b read, the product written) against
// two multiplies; at 2^20 lanes (Engine.msm's decode) 0.083 ms of memory.
// The 22 x 12 kernel before this one loaded its 22 limbs word by word, 88
// bytes apart from the next thread's, so each load instruction of a warp
// touched some 22 sectors, and passed its operands through local memory
// to a non-inlined multiply (0.30 ms at 2^20 lanes).  Here a block's
// 128 lanes of a, b and out are contiguous tiles of 11,264 bytes: a and b
// arrive in shared memory in 16-byte coalesced loads, each thread reads
// its own rows in 8-byte pieces (a warp's 8-byte reads at a stride of 88
// bytes fall in 32 different banks), writes its product into a's tile,
// and the block stores that tile in 16-byte pieces: 0.14 ms at 2^20
// lanes, where per-thread 8-byte loads from device memory took 0.19 (on
// an H100, chip_variants.py, PERF.md).  Operands that are not 16-byte
// aligned (a view one lane in) are copied word by word.
template <class M, bool VEC>
__global__ void __launch_bounds__(BLOCK)
    k_mul(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
          int32_t* __restrict__ out, int n) {
  __shared__ __align__(16) int32_t ta[BLOCK * L];
  __shared__ __align__(16) int32_t tb[BLOCK * L];
  const size_t first = (size_t)blockIdx.x * BLOCK;
  const int count = min(BLOCK, n - (int)first);
  const int words = count * L;
  tile_copy<VEC>(ta, a + first * L, words);
  tile_copy<VEC>(tb, b + first * L, words);
  __syncthreads();
  const int t = threadIdx.x;
  if (t < count) {
    int32_t x[L], y[L];
    const int2* ra = reinterpret_cast<const int2*>(ta + t * L);
    const int2* rb = reinterpret_cast<const int2*>(tb + t * L);
#pragma unroll
    for (int k = 0; k < L / 2; ++k) {
      const int2 u = ra[k], v = rb[k];
      x[2 * k] = u.x;
      x[2 * k + 1] = u.y;
      y[2 * k] = v.x;
      y[2 * k + 1] = v.y;
    }
    int32_t z[L];
    zc32::pack_limbs(zc32::mul_limbs<M>(x, y), z);
    int2* rz = reinterpret_cast<int2*>(ta + t * L);
#pragma unroll
    for (int k = 0; k < L / 2; ++k) rz[k] = make_int2(z[2 * k], z[2 * k + 1]);
  }
  __syncthreads();
  tile_copy<VEC>(out + first * L, ta, words);
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
// On the 8 x 32-bit core, one thread a lane: zc32::madd_affine
// (comb32.cuh), the plain version's field values, written as canonical
// limbs [4][n][22].  The table is [nwin][nent][3][8] words in Montgomery
// form (y+x, y-x, 2dxy: 96 bytes an entry, six 16-byte loads), built once
// for each (width, signed, device) by models/edwards.py.  The load is
// indexed by the secret digit: the comb is not oblivious, as in the
// reference and the JAX package (docs/CONSTANT_TIME.md: not oblivious at
// cache-line granularity).
//
// What bounds it: latency.  A lane's windows run in order (18 at signed
// width 14) with Q in registers, and at 32768 lanes the card holds 1,024
// warps, under two for each scheduler: too few to hide the latency of the
// multiplies' carry chains (one dependent multiply of the core takes about
// 0.84 us) and of the entry's load.  The 7 multiplies a window bound it at
// 0.026 ms of the card's multiply rate; it takes some 0.17 ms, against the
// 22 x 12 kernel's 0.44.  Two designs that shorten the chain ran slower or
// barely faster on an H100 (chip_variants.py, PERF.md): a quad of four
// threads a lane (k_combine's form: 4,096 warps, two dependent multiplies
// a window), which repeats every selection and addition on four threads,
// and each round of independent multiplies interleaved in one rolled loop
// (3-6 % faster, and it spilled: the PTX step's carry flag keeps ptxas from
// interleaving two chains).  The table (14.2 MB at signed width 14, 0.79 MB
// at unsigned width 8) stays in the 50 MB L2.
__global__ void __launch_bounds__(BLOCK)
    k_comb(const uint32_t* __restrict__ tbl, const int32_t* __restrict__ win,
           int nwin, int width, int is_signed, int nent,
           int32_t* __restrict__ out, int n) {
  const int lane = lane_index();
  if (lane >= n) return;
  const int32_t* wl = win + (size_t)lane * nwin;
  const int h = 1 << (width - 1), full = 1 << width;
  zc32::Pt Q;
  Q.X = zc32::fe_zero();
  Q.Y = zc32::fe_one();
  Q.Z = Q.Y;
  Q.T = Q.X;
  int carry = 0;
  for (int w = 0; w < nwin; ++w) {
    int d = __ldg(wl + w) & (full - 1);
    if (is_signed) {
      d += carry;
      carry = d >= h;
      d -= carry * full;
    }
    const int s = -(int)(d < 0);
    const int a = (d ^ s) - s;           // |d|
    const uint4* src = reinterpret_cast<const uint4*>(
        tbl + ((size_t)w * nent + a) * COMB_CORE_WORDS);
    zc32::Fe e[3], f[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint4 lo = __ldg(src + 2 * k), hi = __ldg(src + 2 * k + 1);
      e[k] = zc32::Fe{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
    }
    zc32::comb_factors(f, e, d < 0);
    zc32::madd_affine(Q, f);
  }
  const size_t plane = L * (size_t)n;
  core_store(out, lane, Q.X);
  core_store(out + plane, lane, Q.Y);
  core_store(out + 2 * plane, lane, Q.Z);
  core_store(out + 3 * plane, lane, Q.T);
}

// Row t of a block's tile in shared memory <-> 22 limbs in registers, in
// 8-byte pieces: a warp's reads at a stride of 88 bytes fall in 32
// different banks.
__device__ __forceinline__ void row_in(const int32_t* tile, int t,
                                       int32_t (&x)[L]) {
  const int2* r = reinterpret_cast<const int2*>(tile + t * L);
#pragma unroll
  for (int k = 0; k < L / 2; ++k) {
    const int2 u = r[k];
    x[2 * k] = u.x;
    x[2 * k + 1] = u.y;
  }
}

__device__ __forceinline__ void row_out(int32_t* tile, int t,
                                        const int32_t (&x)[L]) {
  int2* r = reinterpret_cast<int2*>(tile + t * L);
#pragma unroll
  for (int k = 0; k < L / 2; ++k) r[k] = make_int2(x[2 * k], x[2 * k + 1]);
}

// k_canonical -- replaces no Pallas kernel: in the JAX package XLA fused
// the limb engine's canonicalization (limb.canonical and the observers on
// it) into the surrounding program, while in PyTorch the same algebra was
// some 280-550 launches an observation (four exact carries, each a Python
// loop over 21 limb columns ended by a torch.stack).  One thread a lane
// runs zc32::canon_limbs (canon32.cuh) on its 22 limbs in registers and
// writes what MODE asks for (zc32::CanonMode): the canonical limbs, the 32
// little-endian bytes, or a one-byte flag (zero; >= the 22 limbs at
// `bound`; equal to operand b's canonical value).
//
// Bound by bytes: 88 read and at most 88 written a lane (176 in eq mode),
// so 2^20 lanes in and out take 0.055 ms at 3.35 TB/s, against some 600
// integer instructions a lane.  Read in place, the [n][22] rows put a
// warp's loads 88 bytes apart, some 22 sectors a load instruction; so a
// block's 128 rows (11,264 bytes an operand) arrive in shared memory in
// coalesced 16-byte loads (tile_copy, as in k_mul), each thread reads its
// own row in 8-byte pieces, and canonical limbs leave the same way.  Bytes
// leave as two 16-byte stores a lane, flags as one byte a lane.  Nothing
// is allocated at launch.
template <class K, int MODE, bool VEC>
__global__ void __launch_bounds__(BLOCK)
    k_canonical(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                const int32_t* __restrict__ bound, void* __restrict__ out,
                int n) {
  constexpr bool TWO = MODE == zc32::CANON_EQ;
  __shared__ __align__(16) int32_t ta[BLOCK * L];
  __shared__ __align__(16) int32_t tb[TWO ? BLOCK * L : 4];
  const size_t first = (size_t)blockIdx.x * BLOCK;
  const int count = min(BLOCK, n - (int)first);
  const int words = count * L;
  tile_copy<VEC>(ta, a + first * L, words);
  if (TWO) tile_copy<VEC>(tb, b + first * L, words);
  __syncthreads();
  const int t = threadIdx.x;
  if (t < count) {
    int32_t x[L];
    row_in(ta, t, x);
    zc32::canon_limbs<K>(x);
    const size_t lane = first + t;
    if constexpr (MODE == zc32::CANON_LIMBS) {
      row_out(ta, t, x);
    } else if constexpr (MODE == zc32::CANON_BYTES) {
      uint32_t w[8];
      zc32::canon_bytes(x, w);
      uint4* dst = reinterpret_cast<uint4*>(static_cast<uint8_t*>(out) + lane * 32);
      dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
    } else {
      int32_t flag;
      if constexpr (MODE == zc32::CANON_ZERO) {
        flag = zc32::limbs_zero(x);
      } else if constexpr (MODE == zc32::CANON_GEQ) {
        flag = zc32::limbs_geq(x, [&](int i) { return __ldg(bound + i); });
      } else {
        int32_t y[L];
        row_in(tb, t, y);
        zc32::canon_limbs<K>(y);
        flag = zc32::limbs_eq(x, y);
      }
      static_cast<uint8_t*>(out)[lane] = static_cast<uint8_t>(flag);
    }
  }
  if constexpr (MODE == zc32::CANON_LIMBS) {
    __syncthreads();
    tile_copy<VEC>(static_cast<int32_t*>(out) + first * L, ta, words);
  }
}

inline int blocks_for(int n) { return (n + BLOCK - 1) / BLOCK; }

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// True where k_padd may read an operand in 8-byte pieces.
inline bool padd_pairs(const PaddIn& in) {
  bool pairs = in.so % 2 == 0 && in.si % 2 == 0;
  for (int c = 0; c < 4; ++c)
    pairs = pairs && reinterpret_cast<uintptr_t>(in.c[c]) % 8 == 0;
  return pairs;
}

// k_canonical at one mode: 16-byte tile copies where every tile it copies
// is 16-byte aligned.
template <class K, int MODE>
int launch_canonical_at(const int32_t* a, const int32_t* b,
                        const int32_t* bound, void* out, int n,
                        cudaStream_t s) {
  const bool vec = aligned16(a) && (MODE != zc32::CANON_EQ || aligned16(b)) &&
                   (MODE != zc32::CANON_LIMBS || aligned16(out));
  if (vec)
    k_canonical<K, MODE, true><<<blocks_for(n), BLOCK, 0, s>>>(a, b, bound, out, n);
  else
    k_canonical<K, MODE, false><<<blocks_for(n), BLOCK, 0, s>>>(a, b, bound, out, n);
  return static_cast<int>(cudaGetLastError());
}

template <class K>
int launch_canonical(int mode, const int32_t* a, const int32_t* b,
                     const int32_t* bound, void* out, int n, cudaStream_t s) {
  switch (mode) {
    case zc32::CANON_LIMBS:
      return launch_canonical_at<K, zc32::CANON_LIMBS>(a, b, bound, out, n, s);
    case zc32::CANON_BYTES:
      return launch_canonical_at<K, zc32::CANON_BYTES>(a, b, bound, out, n, s);
    case zc32::CANON_ZERO:
      return launch_canonical_at<K, zc32::CANON_ZERO>(a, b, bound, out, n, s);
    case zc32::CANON_GEQ:
      return launch_canonical_at<K, zc32::CANON_GEQ>(a, b, bound, out, n, s);
    case zc32::CANON_EQ:
      return launch_canonical_at<K, zc32::CANON_EQ>(a, b, bound, out, n, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace zc

// ---- launchers (plain C interface) ----------------------------------------

extern "C" {

// a, b, out: [n][22]; spec 0 multiplies mod p, 1 mod r.
int zc_mul(const int32_t* a, const int32_t* b, int32_t* out, int n, int spec,
           void* stream) {
  const bool vec = zc::aligned16(a) && zc::aligned16(b) && zc::aligned16(out);
  void (*kernel)(const int32_t*, const int32_t*, int32_t*, int) =
      spec ? (vec ? zc::k_mul<zc32::ModR, true> : zc::k_mul<zc32::ModR, false>)
           : (vec ? zc::k_mul<zc32::ModP, true> : zc::k_mul<zc32::ModP, false>);
  kernel<<<zc::blocks_for(n), zc::BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, out, n);
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

// tbl: [nwin][nent][3][8] comb table in the core's form; win: [n][nwin]
// digits; out: [4][n][22].
int zc_comb(const int32_t* tbl, const int32_t* win, int nwin, int width,
            int is_signed, int nent, int32_t* out, int n, void* stream) {
  zc::k_comb<<<zc::blocks_for(n), zc::BLOCK, 0,
               static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(tbl), win, nwin, width, is_signed,
      nent, out, n);
  return static_cast<int>(cudaGetLastError());
}

// a, b: [n][22] (b read in mode 4 only); bound: 22 limbs (mode 3 only);
// out: [n][22] int32 (mode 0), [n][32] bytes (1) or [n] flags (2-4).
// spec 0 canonicalizes mod p, 1 mod r; mode is a zc32::CanonMode.
int zc_canonical(const int32_t* a, const int32_t* b, const int32_t* bound,
                 void* out, int n, int spec, int mode, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return spec ? zc::launch_canonical<zc32::LimbR>(mode, a, b, bound, out, n, s)
              : zc::launch_canonical<zc32::LimbP>(mode, a, b, bound, out, n, s);
}

}  // extern "C"
