"""PyTorch port: host rehearsal of the 8 x 32-bit field core of
``k_bucket_accum`` (``zerocaf_tpu_torch/csrc/field32.cuh``).

The header is plain C++ whose functions are all ``__host__ __device__
__forceinline__``.  Here ``g++ -std=c++20 -O1`` compiles it for the host,
through a shim that defines those qualifiers away, into a small shared
library that ``ctypes`` loads; the tests hold its multiply, square, add,
subtract, the conversions across the 22 x 12-bit boundary and one
``padd_ext`` (with the curve constant that ``k_bucket_accum`` reads)
against the port's oracle.  They skip where there is no ``g++``."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from zerocaf_tpu_torch import oracle as o

CSRC = Path(__file__).resolve().parents[1] / "zerocaf_tpu_torch" / "csrc"
R = 1 << 256
P = o.P

SHIM = """
#define __host__
#define __device__
#define __forceinline__ inline
"""

BINDINGS = r"""
#include "shim.h"
#include "field32.cuh"

using namespace zc32;

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
                    "-fPIC", f"-I{d}", f"-I{CSRC}", "-o", str(so),
                    str(d / "bindings.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    p = ctypes.c_void_p
    for name, nargs in (("f32_mul", 3), ("f32_add", 3), ("f32_sub", 3),
                        ("f32_sqr", 2), ("f32_from_limbs", 2),
                        ("f32_to_limbs", 2), ("f32_padd", 4)):
        fn = getattr(lib, name)
        fn.argtypes = [p] * nargs + [ctypes.c_int]
        fn.restype = None
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


def _kernel_d():
    """The words of ``c_d32``, the curve constant in msm_kernels.cu."""
    src = (CSRC / "msm_kernels.cu").read_text()
    body = re.search(r"__constant__ zc32::Fe c_d32 = \{\{([^}]*)\}\};", src)[1]
    return np.array([int(w.strip().rstrip("u"), 16) for w in body.split(",")],
                    dtype=np.uint32)


def test_kernel_d_is_d_in_montgomery_form():
    assert _ints([_kernel_d()]) == [o.EDWARDS_D * R % P]


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
    the HWCD formula of field.cuh's padd_ext."""
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
