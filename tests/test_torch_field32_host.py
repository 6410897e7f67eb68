"""PyTorch port: host rehearsal of the 8 x 32-bit field core of every
kernel (``zerocaf_tpu_torch/csrc/field32.cuh``, modulo p and modulo r), of
the per-lane bodies of ``k_mul`` (``mul_limbs``), the ladder
(``csrc/ladder32.cuh``), the power chain (``csrc/pow32.cuh``) and the comb
(``csrc/comb32.cuh``), and of ``k_combine``'s four-thread point operations
(``csrc/quad32.cuh``).

The headers are plain C++ whose functions are all ``__host__ __device__
__forceinline__``.  Here ``g++ -std=c++20 -O1`` compiles them for the host,
through a shim that defines those qualifiers away, into one small shared
library that ``ctypes`` loads; the tests hold its multiply, square, add,
subtract, the SOS square, the conversions across the 22 x 12-bit
boundary, the moduli's constants, the point formulas (``padd_ext``, ``pdbl``, ``madd``,
``to_niels``, the comb's ``madd_affine``, with the curve constants the
kernels read, and their four-thread forms, the four roles run as host
threads that exchange through an array), K1's lane, the ladder and the
power chain against the port's oracle and its plain versions.  They skip
where there is no ``g++``."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import canon_cases as cc
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from zerocaf_tpu_torch import oracle as o
from zerocaf_tpu_torch.ops import limb as tl
from zerocaf_tpu_torch.ops.kernels import field_kernels as fk

CSRC = Path(__file__).resolve().parents[1] / "zerocaf_tpu_torch" / "csrc"
R = 1 << 256
P = o.P

SHIM = """
#define __host__
#define __device__
#define __forceinline__ inline
#define __constant__
"""

BINDINGS = r"""
#include <barrier>
#include <cstring>
#include <thread>

#include "shim.h"
#include "canon32.cuh"
#include "comb32.cuh"
#include "ladder32.cuh"
#include "pow32.cuh"
#include "quad32.cuh"

using namespace zc32;

// Signed lazy 22 x 12 limbs of a point [4][22] -> the core's form, and
// canonical limbs back.
static Pt pt_in(const int32_t* x) {
  Pt P;
  Fe* cs[4] = {&P.X, &P.Y, &P.Z, &P.T};
  for (int c = 0; c < 4; ++c) {
    int32_t v[NL];
    for (int k = 0; k < NL; ++k) v[k] = x[NL * c + k];
    *cs[c] = to_mont(from_limbs(v));
  }
  return P;
}
static void pt_out(int32_t* x, Pt& P) {
  for (int c = 0; c < 4; ++c) {
    int32_t v[NL];
    to_limbs(coord(P, c), v);
    for (int k = 0; k < NL; ++k) x[NL * c + k] = v[k];
  }
}

// One lane's table: an array [entry][word].
struct HostTable {
  uint32_t* base;
  void get(int entry, int q, uint32_t (&v)[4]) const {
    for (int j = 0; j < 4; ++j) v[j] = base[entry * NIELS_WORDS + 4 * q + j];
  }
  void put(int entry, int q, const uint32_t (&v)[4]) const {
    for (int j = 0; j < 4; ++j) base[entry * NIELS_WORDS + 4 * q + j] = v[j];
  }
};

static Fe get(const uint32_t* p) {
  Fe r;
  for (int i = 0; i < NW; ++i) r.w[i] = p[i];
  return r;
}
static void put(uint32_t* p, const Fe& a) {
  for (int i = 0; i < NW; ++i) p[i] = a.w[i];
}

extern "C" {
void f32_mul(const uint32_t* a, const uint32_t* b, uint32_t* out, int n) {
  for (int i = 0; i < n; ++i) put(out + 8 * i, fe_mul(get(a + 8 * i), get(b + 8 * i)));
}
void f32_sqr(const uint32_t* a, uint32_t* out, int n) {
  for (int i = 0; i < n; ++i) put(out + 8 * i, fe_sq(get(a + 8 * i)));
}
void f32_add(const uint32_t* a, const uint32_t* b, uint32_t* out, int n) {
  for (int i = 0; i < n; ++i) put(out + 8 * i, fe_add(get(a + 8 * i), get(b + 8 * i)));
}
void f32_sub(const uint32_t* a, const uint32_t* b, uint32_t* out, int n) {
  for (int i = 0; i < n; ++i) put(out + 8 * i, fe_sub(get(a + 8 * i), get(b + 8 * i)));
}
void f32_half(const uint32_t* a, uint32_t* out, int n) {
  for (int i = 0; i < n; ++i) put(out + 8 * i, fe_half(get(a + 8 * i)));
}
void f32_from_limbs(const int32_t* x, uint32_t* out, int n) {
  for (int i = 0; i < n; ++i) {
    int32_t v[NL];
    for (int k = 0; k < NL; ++k) v[k] = x[NL * i + k];
    put(out + 8 * i, to_mont(from_limbs(v)));
  }
}
void f32_to_limbs(const uint32_t* a, int32_t* out, int n) {
  for (int i = 0; i < n; ++i) {
    int32_t v[NL];
    to_limbs(get(a + 8 * i), v);
    for (int k = 0; k < NL; ++k) out[NL * i + k] = v[k];
  }
}
void f32_padd(const uint32_t* p, const uint32_t* q, const uint32_t* d,
              uint32_t* out, int n) {
  for (int i = 0; i < n; ++i) {
    Pt P, Q, Rr;
    P.X = get(p + 32 * i); P.Y = get(p + 32 * i + 8);
    P.Z = get(p + 32 * i + 16); P.T = get(p + 32 * i + 24);
    Q.X = get(q + 32 * i); Q.Y = get(q + 32 * i + 8);
    Q.Z = get(q + 32 * i + 16); Q.T = get(q + 32 * i + 24);
    padd_ext(Rr, P, Q, get(d));
    put(out + 32 * i, Rr.X); put(out + 32 * i + 8, Rr.Y);
    put(out + 32 * i + 16, Rr.Z); put(out + 32 * i + 24, Rr.T);
  }
}
void f32_consts(uint32_t* out) {
  put(out, c_d32);
  put(out + 8, c_d2_32);
}
// Point formulas on points given as limbs [n][4][22], results canonical:
// op 0 pdbl with T, 1 pdbl without T, 2 madd(a, b), 3 to_niels(a),
// 4 padd_ext(a, b) in Montgomery form, 5 k_padd's lane: padd_plain on
// plain values, read coordinate by coordinate.
void f32_points(int op, const int32_t* a, const int32_t* b, int32_t* out,
                int n) {
  for (int i = 0; i < n; ++i) {
    if (op == 5) {
      const auto ld = [&](int o, int c) {
        int32_t v[NL];
        for (int k = 0; k < NL; ++k) v[k] = (o ? b : a)[88 * i + NL * c + k];
        return from_limbs(v);
      };
      Fe efgh[4];
      padd_plain(ld, c_d32, efgh);
      for (int c = 0; c < 4; ++c) {
        int32_t v[NL];
        pack_limbs(padd_plain_coord(efgh, c), v);
        for (int k = 0; k < NL; ++k) out[88 * i + NL * c + k] = v[k];
      }
      continue;
    }
    Pt P = pt_in(a + 88 * i), Q = pt_in(b + 88 * i);
    if (op == 0 || op == 1) pdbl(P, op == 0);
    if (op == 2) madd(P, Q);
    if (op == 3) to_niels(P, P, c_d2_32);
    if (op == 4) padd_ext(P, P, Q, c_d32);
    pt_out(out + 88 * i, P);
  }
}
// k_ladder's lanes: points [n][4][22] limbs, windows [n][nwin] -> k*P as
// canonical limbs [n][4][22].
void f32_ladder(const int32_t* pts, const int32_t* win, int nwin, int width,
                int is_signed, int32_t* out, int n) {
  static uint32_t tbl[17 * NIELS_WORDS];
  for (int i = 0; i < n; ++i) {
    Pt P = pt_in(pts + 88 * i), Q;
    const int32_t* wl = win + nwin * i;
    ladder_lane(Q, P, [&](int w) { return wl[w]; }, nwin, width, is_signed,
                HostTable{tbl}, c_d32, c_d2_32);
    pt_out(out + 88 * i, Q);
  }
}

}  // extern "C"

// The moduli's constants: R, R^2, R^4 mod m and -m^-1 mod 2^32 (spec 0:
// p, 1: r), 25 words.
template <class M>
static void consts_of(uint32_t* out) {
  for (int i = 0; i < NW; ++i) {
    out[i] = M::one(i);
    out[8 + i] = M::r2(i);
    out[16 + i] = M::r4(i);
  }
  out[24] = M::INV;
}

extern "C" {
void f32_mod_consts(int spec, uint32_t* out) {
  spec ? consts_of<ModR>(out) : consts_of<ModP>(out);
}

// Field operations mod r (op 0 mul, 1 sqr, 2 add, 3 sub, 4 half), Montgomery
// form in and out; 5 and 6 convert limbs [n][22] to v R mod r and words to
// canonical limbs.
void f32r_op(int op, const void* a, const uint32_t* b, void* out, int n) {
  const uint32_t* aw = static_cast<const uint32_t*>(a);
  uint32_t* ow = static_cast<uint32_t*>(out);
  for (int i = 0; i < n; ++i) {
    if (op == 5) {
      int32_t v[NL];
      for (int k = 0; k < NL; ++k) v[k] = static_cast<const int32_t*>(a)[NL * i + k];
      put(ow + 8 * i, to_mont<ModR>(from_limbs<ModR>(v)));
      continue;
    }
    if (op == 6) {
      int32_t v[NL];
      to_limbs<ModR>(get(aw + 8 * i), v);
      for (int k = 0; k < NL; ++k) static_cast<int32_t*>(out)[NL * i + k] = v[k];
      continue;
    }
    const Fe x = get(aw + 8 * i), y = get(b + 8 * i);
    put(ow + 8 * i, op == 0 ? fe_mul<ModR>(x, y) : op == 1 ? fe_sq<ModR>(x)
                  : op == 2 ? fe_add<ModR>(x, y) : op == 3 ? fe_sub<ModR>(x, y)
                  : fe_half<ModR>(x));
  }
}

}  // extern "C"

// The SOS square of words [n][8] in Montgomery form (spec 0: p, 1: r).
template <class M>
static void sos_squares(const uint32_t* a, uint32_t* out, int n) {
  for (int i = 0; i < n; ++i) ::put(out + 8 * i, fe_sq_sos<M>(::get(a + 8 * i)));
}

extern "C" {
void f32_sqr_sos(int spec, const uint32_t* a, uint32_t* out, int n) {
  spec ? sos_squares<ModR>(a, out, n) : sos_squares<ModP>(a, out, n);
}
}  // extern "C"

// One lane's power-chain table: an array [entry][word].
struct HostPowTable {
  uint32_t* base;
  Fe get(int k) const { return ::get(base + NW * k); }
  void put(int k, const Fe& v) const { ::put(base + NW * k, v); }
};

// k_pow's lanes: limbs [n][22] (any int32) -> a^e mod m as canonical limbs,
// e given by its width-4 digits, most significant first.
template <class M>
static void pow_lanes(const int32_t* a, const int32_t* digits, int nwin,
                      int32_t* out, int n) {
  uint32_t tbl[POW_ENTRIES * NW];
  for (int i = 0; i < n; ++i) {
    int32_t v[NL];
    for (int k = 0; k < NL; ++k) v[k] = a[NL * i + k];
    const Fe r = pow_lane<M>(to_mont<M>(from_limbs<M>(v)),
                             [&](int w) { return digits[w]; }, nwin,
                             HostPowTable{tbl});
    to_limbs<M>(r, v);
    for (int k = 0; k < NL; ++k) out[NL * i + k] = v[k];
  }
}

extern "C" {
void f32_pow(int spec, const int32_t* a, const int32_t* digits, int nwin,
             int32_t* out, int n) {
  spec ? pow_lanes<ModR>(a, digits, nwin, out, n)
       : pow_lanes<ModP>(a, digits, nwin, out, n);
}

// k_combine's point operations on points [n][4][22] limbs, each run by
// four host threads, role j holding coordinate j: op 0 P + Q with Q's
// round-1 operands read from memory (its T as d T, as k_combine's bucket
// sums and totals), 1 P + Q with Q held by the quad (the running sum's
// tot += acc), 2 2P.  Results as canonical limbs.
void f32_quad(int op, const int32_t* a, const int32_t* b, int32_t* out, int n) {
  for (int i = 0; i < n; ++i) {
    Pt P = pt_in(a + 88 * i), Q = pt_in(b + 88 * i);
    Pt R;
    Fe slot[4];
    std::barrier<> bar(4);
    const Fe one = fe_one();
    std::thread roles[4];
    for (int j = 0; j < 4; ++j) {
      roles[j] = std::thread([&, j] {
        const auto x = [&](const Fe& v, int s) {
          slot[j] = v;
          bar.arrive_and_wait();
          const Fe r = slot[s];
          bar.arrive_and_wait();
          return r;
        };
        Fe v = coord(P, j);
        if (op == 0) {
          Fe qa = coord(Q, quad_add_a(j)), qb = coord(Q, quad_add_b(j));
          if (j == 2) qa = qb = fe_mul(qa, c_d32);
          quad_padd(v, quad_operand(qa, qb, j), j, x);
        } else if (op == 1) {
          quad_padd(v, quad_held_operand(coord(Q, j), j, x, c_d32, one), j, x);
        } else {
          quad_pdbl(v, j, x);
        }
        (j == 0 ? R.X : j == 1 ? R.Y : j == 2 ? R.Z : R.T) = v;
      });
    }
    for (auto& t : roles) t.join();
    pt_out(out + 88 * i, R);
  }
}
}

// K1's lanes (mul_limbs): limbs [n][22] a and b (any int32) -> a b mod m
// as canonical limbs.
template <class M>
static void mul_lanes(const int32_t* a, const int32_t* b, int32_t* out, int n) {
  for (int i = 0; i < n; ++i) {
    int32_t x[NL], y[NL], z[NL];
    for (int k = 0; k < NL; ++k) {
      x[k] = a[NL * i + k];
      y[k] = b[NL * i + k];
    }
    pack_limbs(mul_limbs<M>(x, y), z);
    for (int k = 0; k < NL; ++k) out[NL * i + k] = z[k];
  }
}

extern "C" {
void f32_mul_limbs(int spec, const int32_t* a, const int32_t* b, int32_t* out,
                   int n) {
  spec ? mul_lanes<ModR>(a, b, out, n) : mul_lanes<ModP>(a, b, out, n);
}

// k_comb's addition Q += e of points [n][4][22] limbs and affine-Niels
// entries [n][3][22] limbs (y+x, y-x, 2dxy), negated where neg[i] != 0 (a
// negative digit), as the kernel runs it: comb_factors, then madd_affine.
// Canonical limbs out.
void f32_comb(const int32_t* a, const int32_t* e, const int32_t* neg,
              int32_t* out, int n) {
  for (int i = 0; i < n; ++i) {
    Pt P = pt_in(a + 88 * i);
    Fe ent[3], f[3];
    for (int c = 0; c < 3; ++c) {
      int32_t v[NL];
      for (int k = 0; k < NL; ++k) v[k] = e[66 * i + NL * c + k];
      ent[c] = to_mont(from_limbs(v));
    }
    comb_factors(f, ent, neg[i] != 0);
    madd_affine(P, f);
    pt_out(out + 88 * i, P);
  }
}
}

// k_canonical's lanes modulo K's modulus: limbs a [n][22] (b: the second
// operand, mode 4; bound: 22 limbs, mode 3) -> canonical limbs [n][22]
// (mode 0), 32 bytes [n][32] (1) or one-byte flags [n] (2-4).
template <class K>
static void canon_lanes(int mode, const int32_t* a, const int32_t* b,
                        const int32_t* bound, uint8_t* out, int n) {
  for (int i = 0; i < n; ++i) {
    int32_t x[NL], y[NL];
    for (int k = 0; k < NL; ++k) {
      x[k] = a[NL * i + k];
      y[k] = b[NL * i + k];
    }
    canon_limbs<K>(x);
    if (mode == CANON_LIMBS) {
      std::memcpy(out + 4 * NL * i, x, sizeof x);
    } else if (mode == CANON_BYTES) {
      uint32_t w[8];
      canon_bytes(x, w);
      std::memcpy(out + 32 * i, w, sizeof w);
    } else if (mode == CANON_ZERO) {
      out[i] = limbs_zero(x);
    } else if (mode == CANON_GEQ) {
      out[i] = limbs_geq(x, [&](int k) { return bound[k]; });
    } else {
      canon_limbs<K>(y);
      out[i] = limbs_eq(x, y);
    }
  }
}

template <class K>
static void canon_consts_of(int32_t* out) {
  for (int i = 0; i < NL; ++i) {
    out[i] = K::m(i);
    out[NL + i] = K::m64(i);
  }
  for (int j = 0; j < NFOLD; ++j) out[2 * NL + j] = K::c(j);
  out[2 * NL + NFOLD] = K::FL;
  out[2 * NL + NFOLD + 1] = K::FB;
}

extern "C" {
void f32_canon(int spec, int mode, const int32_t* a, const int32_t* b,
               const int32_t* bound, uint8_t* out, int n) {
  spec ? canon_lanes<LimbR>(mode, a, b, bound, out, n)
       : canon_lanes<LimbP>(mode, a, b, bound, out, n);
}

// canon32.cuh's constants (spec 0: p, 1: r): m and 64 m (22 limbs each),
// the fold constant c (12 limbs), then the fold's limb and bit.
void f32_canon_consts(int spec, int32_t* out) {
  spec ? canon_consts_of<LimbR>(out) : canon_consts_of<LimbP>(out);
}
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the field32 host rehearsal needs it")
    d = tmp_path_factory.mktemp("field32")
    (d / "shim.h").write_text(SHIM)
    (d / "bindings.cpp").write_text(BINDINGS)
    so = d / "libfield32.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-Wno-unknown-pragmas", "-shared",
                    "-fPIC", "-pthread", f"-I{d}", f"-I{CSRC}", "-o", str(so),
                    str(d / "bindings.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    p = ctypes.c_void_p
    for name, nargs in (("f32_mul", 3), ("f32_add", 3), ("f32_sub", 3),
                        ("f32_sqr", 2), ("f32_half", 2), ("f32_from_limbs", 2),
                        ("f32_to_limbs", 2), ("f32_padd", 4)):
        fn = getattr(lib, name)
        fn.argtypes = [p] * nargs + [ctypes.c_int]
        fn.restype = None
    i = ctypes.c_int
    for name, argtypes in (("f32_consts", [p]),
                           ("f32_points", [i, p, p, p, i]),
                           ("f32_ladder", [p, p, i, i, i, p, i]),
                           ("f32_mod_consts", [i, p]),
                           ("f32_sqr_sos", [i, p, p, i]),
                           ("f32r_op", [i, p, p, p, i]),
                           ("f32_pow", [i, p, p, i, p, i]),
                           ("f32_quad", [i, p, p, p, i]),
                           ("f32_mul_limbs", [i, p, p, p, i]),
                           ("f32_comb", [p, p, p, p, i]),
                           ("f32_canon", [i, i, p, p, p, p, i]),
                           ("f32_canon_consts", [i, p])):
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = None
    return lib


def _words(vals):
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
                     for v in vals], dtype=np.uint32)


def _ints(words):
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in words]


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _call(lib, name, *arrays, out_shape, dtype=np.uint32):
    out = np.zeros(out_shape, dtype=dtype)
    args = [np.ascontiguousarray(a) for a in arrays]
    getattr(lib, name)(*[_ptr(a) for a in args], _ptr(out), out_shape[0])
    return out


def _mont(vals):
    return _words([v % P * R % P for v in vals])


def _kernel_const(name="c_d32"):
    """The words of a curve constant of field32.cuh (``c_d32``, d; or
    ``c_d2_32``, 2d), as the source writes them."""
    src = (CSRC / "field32.cuh").read_text()
    body = re.search(rf"__constant__ Fe {name} = \{{\{{([^}}]*)\}}\}};", src)[1]
    return np.array([int(w.strip().rstrip("u"), 16) for w in body.split(",")],
                    dtype=np.uint32)


def _kernel_d():
    return _kernel_const("c_d32")


def test_kernel_d_is_d_in_montgomery_form():
    assert _ints([_kernel_d()]) == [o.EDWARDS_D * R % P]


def test_kernel_2d_is_2d_in_montgomery_form(lib):
    """2d R mod p, as the source writes it and as the compiled header holds
    it (beside d)."""
    assert _ints([_kernel_const("c_d2_32")]) == [2 * o.EDWARDS_D * R % P]
    got = np.zeros(16, dtype=np.uint32)
    lib.f32_consts(_ptr(got))
    assert _ints(got.reshape(2, 8)) == [o.EDWARDS_D * R % P,
                                        2 * o.EDWARDS_D * R % P]


EDGES = [0, 1, 2, P - 1, P - 2, (1 << 252) - 1, 1 << 252, R % P, R * R % P]


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(81)
    rand = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(40)]
    a = EDGES + rand
    b = list(reversed(EDGES)) + rand[::-1]
    return a, b


@pytest.mark.parametrize("op", ["mul", "sqr", "add", "sub"])
def test_field_ops_match_the_oracle(lib, operands, op):
    """Inputs and outputs in Montgomery form (v R mod p, in [0, p))."""
    a, b = operands
    want = {"mul": [o.fmul(x, y) for x, y in zip(a, b)],
            "sqr": [o.fsquare(x) for x in a],
            "add": [o.fadd(x, y) for x, y in zip(a, b)],
            "sub": [o.fsub(x, y) for x, y in zip(a, b)]}[op]
    ins = (_mont(a),) if op == "sqr" else (_mont(a), _mont(b))
    got = _ints(_call(lib, f"f32_{op}", *ins, out_shape=(len(a), 8)))
    assert got == [w * R % P for w in want]


def _lazy_limbs(rng, n):
    """Signed lazy limbs as the limb engine leaves them (semi limbs a few
    adds deep, negated, a negative top limb), and the int32 extremes."""
    rows = [o.int_to_limbs(v) for v in (0, 1, P - 1, P, P + 1, 2 * P)]
    rows += [o.int_to_limbs(v) for v in ((1 << 256) - 1, (1 << 256) - 2,
                                         (1 << 256) - P)]
    rows += [[(1 << 31) - 1] * 22, [-(1 << 31)] * 22,
             [-(1 << 31)] * 21 + [(1 << 31) - 1], [4095] * 21 + [-(1 << 31)]]
    for depth in (1, 2, 4):
        semi = rng.integers(-13, 4096 + 13, (n, 22)) * depth
        semi[:, 21] = rng.integers(-(1 << 13), 1 << 13, n) * depth
        rows += semi.tolist()
    rows += (-rng.integers(0, 4096, (n, 22))).tolist()
    return np.array(rows, dtype=np.int64).astype(np.int32)


def test_limbs_to_core_and_back(lib):
    """22 x 12 limbs of any sign and size -> v R mod p -> canonical limbs."""
    rng = np.random.default_rng(82)
    limbs = _lazy_limbs(rng, 20)
    vals = [sum(int(x) << (12 * k) for k, x in enumerate(row)) % P for row in limbs]
    mont = _call(lib, "f32_from_limbs", limbs, out_shape=(len(limbs), 8))
    assert _ints(mont) == [v * R % P for v in vals]
    back = _call(lib, "f32_to_limbs", mont, out_shape=(len(limbs), 22),
                 dtype=np.int32)
    assert back.tolist() == [o.int_to_limbs(v) for v in vals]


def test_padd_ext_matches_the_oracle(lib):
    """One unified addition on oracle points, identity and doubling cases
    included: projectively the oracle's sum, and coordinate for coordinate
    the HWCD formula of the plain padd_tiled_ref (field_kernels.py)."""
    rng = np.random.default_rng(83)
    pts = [o.scalar_mul(o.BASEPOINT, int(k)) for k in rng.integers(1, 1 << 62, 6)]
    ps = pts + [o.IDENTITY, pts[0], pts[1]]
    qs = pts[::-1] + [pts[2], pts[0], o.point_neg(pts[1])]
    d = o.EDWARDS_D
    got = _call(lib, "f32_padd", _mont([c for p in ps for c in p]).reshape(-1, 32),
                _mont([c for q in qs for c in q]).reshape(-1, 32),
                _kernel_d(), out_shape=(len(ps), 32))
    rinv = pow(R, -1, P)
    for p, q, row in zip(ps, qs, got):
        r = tuple(v * rinv % P for v in _ints(row.reshape(4, 8)))
        assert o.point_eq(r, o.point_add(p, q))
        (X1, Y1, Z1, T1), (X2, Y2, Z2, T2) = p, q
        A, B = X1 * X2 % P, Y1 * Y2 % P
        Cc, Dd = T1 * T2 % P * d % P, Z1 * Z2 % P
        E = ((X1 + Y1) * (X2 + Y2) - A - B) % P
        F, G, H = (Dd - Cc) % P, (Dd + Cc) % P, (A + B) % P
        assert r == (E * F % P, G * H % P, F * G % P, E * H % P)


def _lazy_point_limbs(rng, pt):
    """An extended point as signed lazy limbs [4, 22], as the limb engine
    hands them to the kernels: each coordinate's canonical limbs, its
    negative's limbs negated, or either with carries moved between limbs."""
    rows = []
    for v in pt:
        form = int(rng.integers(0, 4))
        limbs = np.array(o.int_to_limbs((P - v) % P if form & 1 else v), np.int64)
        if form & 1:
            limbs = -limbs
        if form & 2:                         # move r 2^12 down from limb k+1
            r = rng.integers(-3, 4, 21)
            limbs[:21] += r * 4096
            limbs[1:] -= r
        rows.append(limbs)
    return np.array(rows).astype(np.int32)


def _coords_of(rows):
    """[n, 4, 22] limbs -> the 4-tuple of [n, 22] tensors."""
    return tuple(torch.tensor(np.ascontiguousarray(rows[:, c])) for c in range(4))


def _canonical_rows(coords):
    """A 4-tuple of [n, 22] tensors -> canonical limbs [n, 4, 22]."""
    return np.stack([tl.canonical(c, tl.FIELD).numpy() for c in coords], axis=1)


def _point_of(row):
    return tuple(o.limbs_to_int(r) % P for r in row)


@pytest.fixture(scope="module")
def lazy_points():
    """Random group points scaled by random Z, the identity, and a point
    with its negative, each as signed lazy limbs; (limbs a, limbs b, the
    oracle points a, b)."""
    rng = np.random.default_rng(84)
    pts = [o.scalar_mul(o.BASEPOINT, int(k)) for k in rng.integers(1, 1 << 62, 8)]
    pts = [tuple(c * int(z) % P for c in p)
           for p, z in zip(pts, rng.integers(2, 1 << 62, 8))]
    a = pts + [o.IDENTITY, pts[0]]
    b = pts[::-1] + [pts[1], o.point_neg(pts[0])]
    la = np.stack([_lazy_point_limbs(rng, p) for p in a])
    lb = np.stack([_lazy_point_limbs(rng, p) for p in b])
    return la, lb, a, b


def _points(lib, op, la, lb):
    out = np.zeros(la.shape, dtype=np.int32)
    lib.f32_points(op, _ptr(np.ascontiguousarray(la)),
                   _ptr(np.ascontiguousarray(lb)), _ptr(out), la.shape[0])
    return out


@pytest.mark.parametrize("op", ["pdbl", "pdbl_no_t", "madd", "to_niels", "padd",
                                "padd_plain"])
def test_point_formulas_match_the_oracle_and_plain(lib, lazy_points, op):
    """The core's pdbl, madd, to_niels, padd_ext and padd_plain (k_padd's
    lane) on signed lazy limbs: canonical limbs equal to the port's plain
    versions (the 22 x 12 algebra, canonicalized) and, coordinate for
    coordinate, to the oracle's formula."""
    la, lb, a, b = lazy_points
    ta, tb = _coords_of(la), _coords_of(lb)
    d2 = o.fmul(2, o.EDWARDS_D)
    if op in ("pdbl", "pdbl_no_t"):
        with_t = op == "pdbl"
        got = _points(lib, 0 if with_t else 1, la, la)
        plain = fk._pdbl_block(ta, with_t=with_t)
        want = [o.point_double(p) for p in a]
        if not with_t:                       # T is left as it was
            plain = plain + (ta[3],)
            want = [w[:3] + (p[3] % P,) for w, p in zip(want, a)]
    elif op == "to_niels":
        got = _points(lib, 3, la, la)
        plain = fk._niels_table(ta, 2)[1]
        want = [(o.fadd(Y, X), o.fsub(Y, X), Z, o.fmul(T, d2)) for X, Y, Z, T in a]
    elif op == "madd":
        niels = _points(lib, 3, lb, lb)      # b in Niels form, canonical
        got = _points(lib, 2, la, niels)
        plain = fk._madd_block(ta, _coords_of(niels))
        want = []
        for (X1, Y1, Z1, T1), (ep, em, ez, et) in zip(a, (_point_of(r) for r in niels)):
            PP, MM = (Y1 + X1) * ep % P, (Y1 - X1) * em % P
            TT, ZZ2 = T1 * et % P, 2 * Z1 * ez % P
            E, F, G, H = PP - MM, ZZ2 - TT, ZZ2 + TT, PP + MM
            want.append((E * F % P, G * H % P, F * G % P, E * H % P))
    else:
        got = _points(lib, 4 if op == "padd" else 5, la, lb)
        plain = fk.padd_tiled_ref(ta, tb)
        want = [o.point_add(p, q) for p, q in zip(a, b)]
    assert np.array_equal(got, _canonical_rows(plain))
    assert [_point_of(r) for r in got] == [tuple(c % P for c in w) for w in want]
    if op.startswith("padd"):
        assert all(o.point_eq(_point_of(r), o.point_add(p, q))
                   for r, p, q in zip(got, a, b))


def _recoded(windows, width):
    """The signed digits' value, top carry dropped, as k_ladder recodes."""
    h, full, carry, k = 1 << (width - 1), 1 << width, 0, 0
    for i, w in enumerate(windows):
        d = int(w) + carry
        carry = int(d >= h)
        k += (d - carry * full) << (width * i)
    return k


@pytest.mark.parametrize("width,signed", [(1, False), (4, False), (4, True)],
                         ids=["bits", "unsigned_w4", "signed_w4"])
def test_ladder_lanes_match_plain_and_oracle(lib, lazy_points, width, signed):
    """k_ladder's per-lane body (ladder32.cuh) for a few lanes: canonical
    limbs equal to the plain version's, and k P equal to the oracle's.  The
    signed case adds a non-canonical window vector (every window 15), whose
    recode drops its top carry: the result is -P, as in the JAX package."""
    la, _, a, _ = lazy_points
    la, a = la[:4], a[:4]
    rng = np.random.default_rng(85 + width + signed)
    nwin = 250 if width == 1 else 63
    ks = [o.R - 1, 0] + [int.from_bytes(rng.bytes(32), "little") % o.R for _ in a[2:]]
    win = np.array([[(k >> (width * i)) & ((1 << width) - 1) for i in range(nwin)]
                    for k in ks], dtype=np.int32)
    if signed:
        win[-1] = 15
    out = np.zeros(la.shape, dtype=np.int32)
    lib.f32_ladder(_ptr(np.ascontiguousarray(la)), _ptr(win), nwin, width,
                   int(signed), _ptr(out), len(a))
    ref = (fk.scalar_mul_windowed_signed_ref if signed
           else fk.scalar_mul_windowed_stepped_ref)
    plain = ref(_coords_of(la), torch.tensor(win), width)
    assert np.array_equal(out, _canonical_rows(plain))
    for row, p, w in zip(out, a, win):
        k = _recoded(w, width) if signed else sum(int(x) << (width * i)
                                                  for i, x in enumerate(w))
        want = o.scalar_mul(p, k) if k >= 0 else o.point_neg(o.scalar_mul(p, -k))
        assert o.point_eq(_point_of(row), want)
    if signed:
        assert _recoded(win[-1], width) == -1


# --- the second modulus: r ---------------------------------------------------


@pytest.mark.parametrize("spec", ["p", "r"])
def test_moduli_constants_match_the_oracle(lib, spec):
    """R, R^2, R^4 mod m and -m^-1 mod 2^32 as the header holds them, for
    ModP and ModR."""
    m = P if spec == "p" else o.R
    got = np.zeros(25, dtype=np.uint32)
    lib.f32_mod_consts(int(spec == "r"), _ptr(got))
    assert _ints(got[:24].reshape(3, 8)) == [R % m, R * R % m, pow(R, 4, m)]
    assert int(got[24]) == (-pow(m, -1, 1 << 32)) % (1 << 32)


def _r_operands():
    rng = np.random.default_rng(86)
    edges = [0, 1, 2, o.R - 1, o.R - 2, (1 << 249) - 1, 1 << 249, R % o.R,
             R * R % o.R]
    rand = [int.from_bytes(rng.bytes(32), "little") % o.R for _ in range(40)]
    return edges + rand, list(reversed(edges)) + rand[::-1]


@pytest.mark.parametrize("op", ["mul", "sqr", "add", "sub", "half"])
def test_field_ops_mod_r_match_the_oracle(lib, op):
    """The core's multiply, square, add, subtract and halving modulo r, in
    Montgomery form (v R mod r)."""
    r = o.R
    a, b = _r_operands()
    want = {"mul": [x * y % r for x, y in zip(a, b)],
            "sqr": [x * x % r for x in a],
            "add": [(x + y) % r for x, y in zip(a, b)],
            "sub": [(x - y) % r for x, y in zip(a, b)],
            "half": [x * pow(2, -1, r) % r for x in a]}[op]
    mont = [np.ascontiguousarray(_words([v * R % r for v in vals])) for vals in (a, b)]
    out = np.zeros((len(a), 8), dtype=np.uint32)
    code = ["mul", "sqr", "add", "sub", "half"].index(op)
    lib.f32r_op(code, _ptr(mont[0]), _ptr(mont[1]), _ptr(out), len(a))
    assert _ints(out) == [w * R % r for w in want]


def test_field_half_mod_p_matches_the_oracle(lib, operands):
    """fe_half modulo p (k_combine's 4-way addition halves B' - A' and
    B' + A'), in Montgomery form."""
    a, _ = operands
    got = _ints(_call(lib, "f32_half", _mont(a), out_shape=(len(a), 8)))
    assert got == [x * pow(2, -1, P) % P * R % P for x in a]


@pytest.mark.parametrize("spec", ["p", "r"])
def test_sos_square_matches_the_oracle(lib, operands, spec):
    """fe_sq_sos, the dedicated square of k_pow and k_combine, modulo p and
    r, in Montgomery form, edge values included."""
    a = operands[0] if spec == "p" else _r_operands()[0]
    m = P if spec == "p" else o.R
    mont = np.ascontiguousarray(_words([v * R % m for v in a]))
    out = np.zeros((len(a), 8), dtype=np.uint32)
    lib.f32_sqr_sos(int(spec == "r"), _ptr(mont), _ptr(out), len(a))
    assert _ints(out) == [v * v % m * R % m for v in a]


def test_limbs_to_core_and_back_mod_r(lib):
    """22 x 12 limbs of any sign and size -> v R mod r -> canonical limbs
    mod r."""
    rng = np.random.default_rng(87)
    limbs = _lazy_limbs(rng, 20)
    vals = [sum(int(x) << (12 * k) for k, x in enumerate(row)) % o.R for row in limbs]
    mont = np.zeros((len(limbs), 8), dtype=np.uint32)
    lib.f32r_op(5, _ptr(limbs), _ptr(mont), _ptr(mont), len(limbs))
    assert _ints(mont) == [v * R % o.R for v in vals]
    back = np.zeros((len(limbs), 22), dtype=np.int32)
    lib.f32r_op(6, _ptr(mont), _ptr(mont), _ptr(back), len(limbs))
    assert back.tolist() == [o.int_to_limbs(v) for v in vals]


# --- k_pow's lane body ----------------------------------------------------------


def _pow_inputs(spec):
    """Signed lazy limbs as the limb engine hands them to K2 (a product
    minus a factor: semi, maybe negative), and the extremes of int32."""
    rng = np.random.default_rng(88)
    m = P if spec is tl.FIELD else o.R
    a, b = ([int.from_bytes(rng.bytes(32), "little") % m for _ in range(6)]
            for _ in range(2))
    ta = torch.tensor(np.stack([o.int_to_limbs(v) for v in a]).astype(np.int32))
    tb = torch.tensor(np.stack([o.int_to_limbs(v) for v in b]).astype(np.int32))
    semi = tl.sub(fk.mul_tiled_ref(ta, tb, spec), ta).numpy()
    extremes = _lazy_limbs(rng, 1)[9:13]
    return semi, extremes


@pytest.mark.parametrize("e", ["inv", "legendre", "sqrt", "sqrt_ratio", "r-2"])
def test_pow_lane_matches_plain_and_oracle(lib, e):
    """pow32.cuh's lane body for each exponent of the chains mod p and for
    r - 2 mod r: on the limb engine's signed lazy limbs, canonical limbs
    equal to pow_tiled_ref's; on any int32 limbs, a^e equal to the
    oracle's."""
    from zerocaf_tpu_torch import constants as TC
    spec = tl.SCALAR if e == "r-2" else tl.FIELD
    m = o.R if e == "r-2" else P
    exp = {"inv": TC.EXP_INV, "legendre": TC.EXP_LEGENDRE, "sqrt": TC.EXP_SQRT,
           "sqrt_ratio": TC.EXP_SQRT_RATIO, "r-2": o.R - 2}[e]
    digits = np.array(fk.pow_digits(exp), dtype=np.int32)
    semi, extremes = _pow_inputs(spec)
    for limbs in (semi, extremes):
        out = np.zeros(limbs.shape, dtype=np.int32)
        lib.f32_pow(int(spec is tl.SCALAR), _ptr(np.ascontiguousarray(limbs)),
                    _ptr(digits), len(digits), _ptr(out), len(limbs))
        vals = [o.limbs_to_int(row) % m for row in limbs]
        assert [o.limbs_to_int(row) for row in out] == [pow(v, exp, m) for v in vals]
        assert all(0 <= x < 4096 for x in out.flatten())
    plain = fk.pow_tiled_ref(torch.tensor(semi), exp, spec)
    lib.f32_pow(int(spec is tl.SCALAR), _ptr(np.ascontiguousarray(semi)),
                _ptr(digits), len(digits), _ptr(out := np.zeros(semi.shape, np.int32)),
                len(semi))
    assert np.array_equal(out, tl.canonical(plain, spec).numpy())


# --- k_combine's four-thread point operations ----------------------------------


@pytest.mark.parametrize("op", ["padd_read", "padd_held", "pdbl"])
def test_quad_formulas_equal_the_core(lib, lazy_points, op):
    """quad32.cuh's 4-way addition (Q's operands read from memory, or held
    by the quad with its d T a round of its own) and doubling, the four
    roles run as four host threads: equal to padd_ext / pdbl field value
    for field value (canonical limbs), and to the oracle."""
    la, lb, a, b = lazy_points
    code = ["padd_read", "padd_held", "pdbl"].index(op)
    got = np.zeros(la.shape, dtype=np.int32)
    lib.f32_quad(code, _ptr(np.ascontiguousarray(la)), _ptr(np.ascontiguousarray(lb)),
                 _ptr(got), la.shape[0])
    if op == "pdbl":
        assert np.array_equal(got, _points(lib, 0, la, la))
        assert [_point_of(r) for r in got] == [tuple(c % P for c in o.point_double(p))
                                               for p in a]
    else:
        assert np.array_equal(got, _points(lib, 4, la, lb))
        assert all(o.point_eq(_point_of(r), o.point_add(p, q))
                   for r, p, q in zip(got, a, b))


# --- K1's lane and the comb's addition ----------------------------------------


@pytest.mark.parametrize("spec", ["p", "r"])
def test_mul_lane_matches_plain_and_oracle(lib, spec):
    """K1's lane (field32.cuh mul_limbs, two Montgomery products) modulo p
    and r: on semi limbs (a product minus a factor, possibly negative),
    the same limbs negated and one add deep, canonical limbs equal to
    mul_tiled_ref's; on any int32 limbs, the oracle's product."""
    tspec = tl.FIELD if spec == "p" else tl.SCALAR
    m = P if spec == "p" else o.R
    rng = np.random.default_rng(89)
    semi, extremes = _pow_inputs(tspec)
    b = torch.tensor(np.stack([o.int_to_limbs(int.from_bytes(rng.bytes(32), "little") % m)
                               for _ in semi]).astype(np.int32))
    ts = torch.tensor(semi)
    lazy = [(ts, b), (-ts, b), (ts + b, -b)]        # the plain version's inputs
    for i, (x, y) in enumerate(lazy + [(torch.tensor(extremes), b[:4])]):
        x, y = np.ascontiguousarray(x.numpy()), np.ascontiguousarray(y.numpy())
        out = np.zeros(x.shape, dtype=np.int32)
        lib.f32_mul_limbs(int(spec == "r"), _ptr(x), _ptr(y), _ptr(out), len(x))
        vals = [o.limbs_to_int(u) * o.limbs_to_int(v) % m for u, v in zip(x, y)]
        assert [o.limbs_to_int(r) for r in out] == vals
        assert all(0 <= v < 4096 for v in out.flatten())
        if i < len(lazy):
            plain = fk.mul_tiled_ref(torch.tensor(x), torch.tensor(y), tspec)
            assert np.array_equal(out, tl.canonical(plain, tspec).numpy())


def test_comb_addition_matches_plain_and_oracle(lib, lazy_points):
    """The comb's mixed addition on the core (comb32.cuh comb_factors and
    madd_affine) of affine-Niels entries (y+x, y-x, 2dxy), half of them
    negated as a negative digit negates them: canonical limbs equal to the
    plain _madd_affine_block's on the same signed entries, and the
    oracle's sum Q + e, coordinate for coordinate its formula."""
    la, _, a, _ = lazy_points
    rng = np.random.default_rng(90)
    d2 = 2 * o.EDWARDS_D % P
    ents, neg, want = [], [], []
    for i, q in enumerate(a):
        x, y = o.point_to_affine(o.scalar_mul(o.BASEPOINT, int(rng.integers(1, 1 << 40))))
        ents.append([o.int_to_limbs((y + x) % P), o.int_to_limbs((y - x) % P),
                     o.int_to_limbs(d2 * x * y % P)])
        neg.append(i % 2)
        ep, em, et = ((y - x) % P, (y + x) % P, -d2 * x * y % P) if i % 2 else (
            (y + x) % P, (y - x) % P, d2 * x * y % P)
        X1, Y1, Z1, T1 = q
        PP, MM, TT, Z2 = (Y1 + X1) * ep % P, (Y1 - X1) * em % P, T1 * et % P, 2 * Z1
        E, F, G, H = PP - MM, Z2 - TT, Z2 + TT, PP + MM
        want.append((E * F % P, G * H % P, F * G % P, E * H % P))
        sx = (-x if i % 2 else x) % P               # the entry's point, signed
        assert o.point_eq(want[-1], o.point_add(q, (sx, y, 1, sx * y % P)))
    ents = np.array(ents, dtype=np.int32)
    neg = np.array(neg, dtype=np.int32)
    got = np.zeros(la.shape, dtype=np.int32)
    lib.f32_comb(_ptr(np.ascontiguousarray(la)), _ptr(ents), _ptr(neg), _ptr(got),
                 la.shape[0])
    e = [torch.tensor(ents[:, c]) for c in range(3)]
    s = torch.tensor(neg != 0)[:, None]
    plain = fk._madd_affine_block(_coords_of(la), (torch.where(s, e[1], e[0]),
                                                   torch.where(s, e[0], e[1]),
                                                   torch.where(s, -e[2], e[2])))
    assert np.array_equal(got, _canonical_rows(plain))
    assert [_point_of(r) for r in got] == want


# --- k_canonical's lane -------------------------------------------------------


@pytest.mark.parametrize("spec", ["p", "r"])
def test_canonical_constants_match_the_moduli(lib, spec):
    """canon32.cuh's limbs of m, 64 m and the fold constant c (m = 2^K +
    c, K = 12 FL + FB: 252 for p, 249 for r), as the compiled header holds
    them, against the port's constants."""
    tspec, m = (tl.FIELD, P) if spec == "p" else (tl.SCALAR, o.R)
    got = np.zeros(2 * 22 + 14, dtype=np.int32)
    lib.f32_canon_consts(int(spec == "r"), _ptr(got))
    assert got[:22].tolist() == tl.spec_limbs(m, tspec).tolist()
    assert got[22:44].tolist() == tspec.m64_limbs.tolist()
    assert got[44:56].tolist() == tspec.final_c_limbs.tolist()
    fl, fb = got[56:].tolist()
    assert 12 * fl + fb == tspec.final_fold_bits
    assert m == (1 << tspec.final_fold_bits) + o.limbs_to_int(got[44:56])


@pytest.mark.parametrize("mode", cc.MODES)
@pytest.mark.parametrize("spec", ["p", "r"])
def test_canonical_lane_matches_plain_bit_for_bit(lib, spec, mode):
    """k_canonical's lane (canon32.cuh), every mode, modulo p and r: equal
    bit for bit to canonical_tiled_ref, and to Python integers, on the edge
    set and the limb vectors with carry slack."""
    tspec, m, bound = cc.MODULI[spec]
    rows, vals = cc.cases(m, bound)
    kw = cc.mode_args(tspec, m, bound, mode, vals)
    b = kw["other"].numpy() if mode == "eq" else rows
    bnd = np.ascontiguousarray(kw["bound"] if mode == "geq" else rows[0])
    n = len(rows)
    width = {"limbs": 88, "bytes": 32}.get(mode, 1)
    out = np.zeros((n, width), dtype=np.uint8)
    lib.f32_canon(int(spec == "r"), fk.CANON_MODES[mode], _ptr(rows),
                  _ptr(np.ascontiguousarray(b)), _ptr(bnd), _ptr(out), n)
    plain = fk.canonical_tiled_ref(torch.tensor(rows), tspec, mode, **kw).numpy()
    got = out.view(np.int32) if mode == "limbs" else out if mode == "bytes" else (
        out[:, 0].astype(bool))
    assert np.array_equal(got, plain)
    assert got.tolist() == cc.expected(mode, vals, m, bound)
