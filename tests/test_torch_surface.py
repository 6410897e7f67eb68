"""PyTorch port: the library surface -- the Scalar and FieldElement facades,
limb ``cmp`` and ``pow_batched``, the host recoder, traits, the package's
exports and the constructors' default device -- held against the JAX
package on the same seeded inputs and against the oracle.  Canonical
values, tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zerocaf_tpu as jz
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from zerocaf_tpu import native as jnative
from zerocaf_tpu import oracle as o
from zerocaf_tpu.ops import limb as jl
import zerocaf_tpu_torch as tz
from zerocaf_tpu_torch import config, recode, traits
from zerocaf_tpu_torch.models import edwards as ted
from zerocaf_tpu_torch.ops import limb as tl

def _rand(rng, m):
    return int.from_bytes(rng.bytes(40), "little") % m


def _limbs(vals):
    return np.stack([np.array(o.int_to_limbs(v % (1 << 264)), np.int32) for v in vals])


def _canon(v):
    """A facade, mask, int array, or a tuple of them -> nested python lists
    of canonical values."""
    if isinstance(v, (tuple, list)):
        return [_canon(x) for x in v]
    if hasattr(v, "to_ints"):
        ints = v.to_ints()
        return [int(x) for x in np.ravel(np.asarray(ints, dtype=object))]
    return np.asarray(v).tolist()


# --- inputs: lanes with 0, 1, -1, a square, equal operands and a zero divisor

def _field_inputs():
    rng = np.random.default_rng(1101)
    r = [_rand(rng, o.P) for _ in range(8)]
    xs = [0, 1, o.P - 1, r[0] * r[0] % o.P, r[1], r[2]]
    ys = [r[3], 0, 2, r[4], r[1], r[5]]
    return xs, ys


def _scalar_inputs():
    rng = np.random.default_rng(1102)
    r = [_rand(rng, o.R) for _ in range(8)]
    xs = [0, 1, o.R - 1, r[0], r[1], r[2] | 1]
    ys = [r[3], 0, 2, r[4], r[1], r[5]]
    return xs, ys


FX, FY = _field_inputs()
SX, SY = _scalar_inputs()
MASK = [True, False, True, True, False, False]
INV2 = pow(2, o.P - 2, o.P)
SINV2 = pow(2, o.R - 2, o.R)
E_LONG = (1 << 40) + 12345
SHIFTS = (0, 1, 7, 12, 13, 200, 252, 253)


def _qr(a):
    return pow(a, (o.P - 1) // 2, o.P)


def _cmp_all(x, y):
    return (x.cmp(y), x < y, x <= y, x > y, x >= y)


def _ocmp(xs, ys):
    c = [(a > b) - (a < b) for a, b in zip(xs, ys)]
    return [c, [v < 0 for v in c], [v <= 0 for v in c], [v > 0 for v in c],
            [v >= 0 for v in c]]


# name: (function of (pkg, x, y) -> result, oracle of (xs, ys) -> result or
# None where the oracle has no value for some lanes)
FIELD_CASES = {
    "add": (lambda p, x, y: x + y, lambda a, b: [(u + v) % o.P for u, v in zip(a, b)]),
    "sub": (lambda p, x, y: x - y, lambda a, b: [(u - v) % o.P for u, v in zip(a, b)]),
    "neg": (lambda p, x, y: -x, lambda a, b: [(-u) % o.P for u in a]),
    "mul": (lambda p, x, y: x * y, lambda a, b: [u * v % o.P for u, v in zip(a, b)]),
    "square": (lambda p, x, y: x.square(), lambda a, b: [u * u % o.P for u in a]),
    "div": (lambda p, x, y: x / y,
            lambda a, b: [u * pow(v, o.P - 2, o.P) % o.P for u, v in zip(a, b)]),
    "half": (lambda p, x, y: x.half(), lambda a, b: [u * INV2 % o.P for u in a]),
    "inverse": (lambda p, x, y: x.inverse(), lambda a, b: [pow(u, o.P - 2, o.P) for u in a]),
    "pow_short": (lambda p, x, y: x.pow(13), lambda a, b: [pow(u, 13, o.P) for u in a]),
    "pow_long": (lambda p, x, y: x.pow(E_LONG), lambda a, b: [pow(u, E_LONG, o.P) for u in a]),
    "pow_field": (lambda p, x, y: x.pow(y), lambda a, b: [pow(u, v, o.P) for u, v in zip(a, b)]),
    "pow_scalar": (lambda p, x, y: x.pow(p.Scalar.from_int(SY)),
                   lambda a, b: [pow(u, v, o.P) for u, v in zip(a, SY)]),
    "rshift": (lambda p, x, y: tuple(x >> k for k in SHIFTS),
               lambda a, b: [[u >> k for u in a] for k in SHIFTS]),
    "half_without_mod": (lambda p, x, y: (x + x).half_without_mod(),
                         lambda a, b: [(2 * u % o.P) >> 1 for u in a]),
    "legendre_symbol": (lambda p, x, y: (x.legendre_symbol(), x.legendre_symbol_value()),
                        lambda a, b: [[_qr(u) == 1 for u in a], [_qr(u) for u in a]]),
    "mod_sqrt": (lambda p, x, y: (x.mod_sqrt(0), x.mod_sqrt(1)), None),
    "inv_sqrt": (lambda p, x, y: x.inv_sqrt(),
                 lambda a, b: [list(t) for t in zip(*[o.inv_sqrt(u) for u in a])]),
    "sqrt_ratio_i": (lambda p, x, y: x.sqrt_ratio_i(y),
                     lambda a, b: [list(t) for t in zip(*[o.sqrt_ratio_i(u, v)
                                                          for u, v in zip(a, b)])]),
    "cmp": (lambda p, x, y: _cmp_all(x, y), _ocmp),
    "eq_is_zero": (lambda p, x, y: (x.eq(y), x.is_zero()),
                   lambda a, b: [[u == v for u, v in zip(a, b)], [u == 0 for u in a]]),
    "is_positive_abs": (lambda p, x, y: (x.is_positive(), x.abs()),
                        lambda a, b: [[o.is_positive(u) for u in a],
                                      [o.fabs(u) for u in a]]),
    "is_even": (lambda p, x, y: x.is_even(), lambda a, b: [u % 2 == 0 for u in a]),
    "conditional_negate": (lambda p, x, y: x.conditional_negate(MASK),
                           lambda a, b: [(-u if m else u) % o.P for u, m in zip(a, MASK)]),
    "select": (lambda p, x, y: x.select(MASK, y),
               lambda a, b: [u if m else v for u, v, m in zip(a, b, MASK)]),
    "ristretto255_bytes": (lambda p, x, y: p.FieldElement.from_ristretto255_scalar_bytes(
        x.to_ristretto255_scalar_bytes()), lambda a, b: a),
    "shape_plumbing": (lambda p, x, y: (x[1:3].broadcast_to((2, 2)), x[4]),
                       lambda a, b: [a[1:3] * 2, [a[4]]]),
}


def _field_pair(pkg):
    if pkg is jz:
        return (jz.FieldElement(jnp.asarray(_limbs(FX))),
                jz.FieldElement(jnp.asarray(_limbs(FY))))
    return (tz.FieldElement(torch.tensor(_limbs(FX))),
            tz.FieldElement(torch.tensor(_limbs(FY))))


@pytest.mark.parametrize("name", list(FIELD_CASES))
def test_field_facade_matches_jax_and_oracle(name):
    fn, ora = FIELD_CASES[name]
    got = _canon(fn(tz, *_field_pair(tz)))
    assert got == _canon(fn(jz, *_field_pair(jz)))
    if ora is not None:
        assert got == ora(FX, FY)


def test_field_mod_sqrt_oracle_lanes():
    """Where a root exists, mod_sqrt's root is the oracle's for both signs
    (elsewhere both packages return the same unspecified value)."""
    x, _ = _field_pair(tz)
    for sign in (0, 1):
        ok, root = x.mod_sqrt(sign)
        want = [o.mod_sqrt(u, sign) for u in FX]
        assert ok.tolist() == [w is not None for w in want]
        assert [r for r, w in zip(root.to_ints(), want) if w is not None] == \
            [w for w in want if w is not None]


SCALAR_CASES = {
    "add": (lambda p, x, y: x + y, lambda a, b: [(u + v) % o.R for u, v in zip(a, b)]),
    "sub": (lambda p, x, y: x - y, lambda a, b: [(u - v) % o.R for u, v in zip(a, b)]),
    "neg": (lambda p, x, y: -x, lambda a, b: [(-u) % o.R for u in a]),
    "mul": (lambda p, x, y: x * y, lambda a, b: [u * v % o.R for u, v in zip(a, b)]),
    "square": (lambda p, x, y: x.square(), lambda a, b: [u * u % o.R for u in a]),
    "half": (lambda p, x, y: x.half(), lambda a, b: [u * SINV2 % o.R for u in a]),
    "inverse": (lambda p, x, y: x.inverse(), lambda a, b: [pow(u, o.R - 2, o.R) for u in a]),
    "pow_long": (lambda p, x, y: x.pow(E_LONG), lambda a, b: [pow(u, E_LONG, o.R) for u in a]),
    "pow_scalar": (lambda p, x, y: x.pow(y), lambda a, b: [pow(u, v, o.R) for u, v in zip(a, b)]),
    "rshift": (lambda p, x, y: tuple(x >> k for k in SHIFTS[:-2] + (249, 250)),
               lambda a, b: [[u >> k for u in a] for k in SHIFTS[:-2] + (249, 250)]),
    "half_without_mod": (lambda p, x, y: (x + x).half_without_mod(),
                         lambda a, b: [(2 * u % o.R) >> 1 for u in a]),
    "mod_2_pow_k": (lambda p, x, y: tuple(x.mod_2_pow_k(k) for k in (1, 5, 12))
                    + tuple(x.mods_2_pow_k(k) for k in (2, 5, 12)),
                    lambda a, b: [[u % (1 << k) for u in a] for k in (1, 5, 12)]
                    + [[(u % (1 << k)) - ((1 << k) if u % (1 << k) >= 1 << (k - 1) else 0)
                        for u in a] for k in (2, 5, 12)]),
    "cmp": (lambda p, x, y: _cmp_all(x, y), _ocmp),
    "eq_is_zero_is_even": (lambda p, x, y: (x.eq(y), x.is_zero(), x.is_even()),
                           lambda a, b: [[u == v for u, v in zip(a, b)], [u == 0 for u in a],
                                         [u % 2 == 0 for u in a]]),
    "select": (lambda p, x, y: x.select(MASK, y),
               lambda a, b: [u if m else v for u, v, m in zip(a, b, MASK)]),
    "shape_plumbing": (lambda p, x, y: (x[1:3].broadcast_to((2, 2)), x[4]),
                       lambda a, b: [a[1:3] * 2, [a[4]]]),
    "into_bits": (lambda p, x, y: x.into_bits(250),
                  lambda a, b: [[(u >> i) & 1 for i in range(250)] for u in a]),
    "naf": (lambda p, x, y: (x.compute_naf(), x.compute_naf(253)),
            lambda a, b: [[o.compute_naf(u, n) for u in a] for n in (256, 253)]),
    "window_naf": (lambda p, x, y: tuple(x.compute_window_naf(w) for w in range(2, 8)),
                   lambda a, b: [[o.compute_window_naf(u, w) for u in a] for w in range(2, 8)]),
}


def _scalar_pair(pkg):
    return (pkg.Scalar(_asarray(pkg, _limbs(SX))), pkg.Scalar(_asarray(pkg, _limbs(SY))))


def _asarray(pkg, a):
    return jnp.asarray(a) if pkg is jz else torch.tensor(a)


@pytest.mark.parametrize("name", list(SCALAR_CASES))
def test_scalar_facade_matches_jax_and_oracle(name):
    fn, ora = SCALAR_CASES[name]
    got = _canon(fn(tz, *_scalar_pair(tz)))
    assert got == _canon(fn(jz, *_scalar_pair(jz)))
    assert got == ora(SX, SY)


CONSTRUCTORS = {
    "zero": lambda cls: cls.zero(),
    "one": lambda cls: cls.one(),
    "minus_one": lambda cls: cls.minus_one(),
    "two_pow_k": lambda cls: cls.two_pow_k(200),
    "from_int": lambda cls: cls.from_int([5, -1, 1 << 300]),
}


@pytest.mark.parametrize("cls", ["FieldElement", "Scalar"])
@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_constructors_match_jax(cls, name):
    got = CONSTRUCTORS[name](getattr(tz, cls))
    assert got.limbs.device == torch.device("cpu")
    assert _canon(got) == _canon(CONSTRUCTORS[name](getattr(jz, cls)))


@pytest.mark.parametrize("cls", ["FieldElement", "Scalar"])
def test_random_is_uniform_in_range_on_the_default_device(cls):
    """Random draws cannot match JAX's streams: they are held to range,
    shape and device, and to the wide reduction of the drawn bytes."""
    fe = cls == "FieldElement"
    got = getattr(tz, cls).random(torch.Generator().manual_seed(9), (3, 5))
    assert got.shape == (3, 5) and got.limbs.device == torch.device("cpu")
    raw = torch.randint(0, 256, (3, 5, 64), generator=torch.Generator().manual_seed(9),
                        dtype=torch.uint8).numpy().reshape(15, 64)
    m = o.P if fe else o.R
    assert list(np.ravel(got.to_ints())) == [
        int.from_bytes(r.tobytes(), "little") % m for r in raw]


def test_ristretto255_scalar_alias():
    assert tz.Ristretto255Scalar is tz.FieldElement
    assert jz.Ristretto255Scalar is jz.FieldElement


# --- limb cmp and pow_batched -------------------------------------------------

@pytest.mark.parametrize("spec", ["FIELD", "SCALAR"])
def test_limb_cmp_matches_jax_on_semi_limbs(spec):
    """Semi-reduced, negative-limbed and non-canonical operands compare by
    their canonical values."""
    rng = np.random.default_rng(1103)
    m = o.P if spec == "FIELD" else o.R
    vals = [_rand(rng, m) for _ in range(8)]
    a = _limbs(vals)
    b = _limbs(vals[:3] + [(v + m) for v in vals[3:6]] + vals[6:])   # equal values
    b[6, 0] += 5000                                                  # limb above 4095
    b[7] = a[7]
    b[7, 3] += 4096
    b[7, 4] -= 1                                                     # same value
    ta, tb = torch.tensor(a), torch.tensor(b)
    got = tl.cmp(ta, tb, getattr(tl, spec))
    want = np.asarray(jl.cmp(jnp.asarray(a), jnp.asarray(b), getattr(jl, spec)))
    assert got.dtype == torch.int32 and got.tolist() == want.tolist()
    ia, ib = [o.limbs_to_int(r) % m for r in a], [o.limbs_to_int(r) % m for r in b]
    assert got.tolist() == [(u > v) - (u < v) for u, v in zip(ia, ib)]


@pytest.mark.parametrize("spec", ["FIELD", "SCALAR"])
def test_limb_pow_batched_matches_jax(spec):
    rng = np.random.default_rng(1104)
    m = o.P if spec == "FIELD" else o.R
    base = [_rand(rng, m) for _ in range(4)]
    exps = [0, 1, _rand(rng, 1 << 40), _rand(rng, 1 << 40)]
    bits = np.array([[(e >> i) & 1 for i in range(40)] for e in exps], np.int32)
    got = tl.canonical(tl.pow_batched(torch.tensor(_limbs(base)), torch.tensor(bits),
                                      getattr(tl, spec)), getattr(tl, spec))
    want = jl.canonical(jl.pow_batched(jnp.asarray(_limbs(base)), jnp.asarray(bits),
                                       getattr(jl, spec)), getattr(jl, spec))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert [o.limbs_to_int(r) for r in got.numpy()] == [
        pow(b, e, m) for b, e in zip(base, exps)]


# --- the host recoder -----------------------------------------------------------

def _recode_inputs():
    rng = np.random.default_rng(1105)
    ks = [_rand(rng, o.R) for _ in range(12)] + [0, 1, 3, 7, o.R - 1, 2**250 - 1,
                                                 2**251 + 2**250 - 1]
    return np.stack([np.frombuffer(k.to_bytes(32, "little"), np.uint8) for k in ks])


RECODINGS = {
    "naf256": lambda m, b: m.naf(b),
    "naf253": lambda m, b: m.naf(b, 253),
    "naf300": lambda m, b: m.naf(b, 300),
    "bits": lambda m, b: m.bits(b, 250),
    "windows_c6": lambda m, b: m.windows(b, 6, 43),
    "windows_c16": lambda m, b: m.windows(b, 16, 16),
    **{f"wnaf_w{w}": (lambda m, b, w=w: m.wnaf(b, w)) for w in range(2, 9)},
    "wnaf_batched": lambda m, b: m.wnaf(b.reshape(19, 1, 32), 5, 256),
}


@pytest.mark.parametrize("name", list(RECODINGS))
def test_recoder_matches_jax_native(name):
    b = _recode_inputs()
    got = RECODINGS[name](recode, b)
    want = RECODINGS[name](jnative, b)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def test_recoder_domain_check_matches_jax_native():
    b = np.zeros((2, 32), np.uint8)
    b[1, 31] = 0x80                               # 2^255: 257 digits
    for mod in (recode, jnative):
        with pytest.raises(ValueError, match="nbits=256"):
            mod.naf(b)
        with pytest.raises(ValueError, match="nbits=256"):
            mod.wnaf(b, 5)
        b2 = b.copy()
        b2[1, 31] = 0xFF
        with pytest.raises(ValueError, match="2\\^256"):
            mod.naf(b2, 300)


# --- traits, exports and the default device --------------------------------------

def test_traits_are_satisfied_as_in_the_jax_package():
    fe = tz.FieldElement.one()
    sc = tz.Scalar.one()
    pt = tz.EdwardsPoint.identity()
    for obj in (fe, sc):
        assert isinstance(obj, (traits.Square, traits.Half, traits.Pow))
    for t in (traits.ModSqrt, traits.InvSqrt, traits.SqrtRatioI):
        assert isinstance(fe, t) and not isinstance(sc, t)
    for obj in (pt, tz.ProjectivePoint.identity(), tz.RistrettoPoint.identity()):
        assert isinstance(obj, traits.Double)
    for obj in (pt, tz.ProjectivePoint.identity(), tz.AffinePoint.identity(),
                tz.RistrettoPoint.identity()):
        assert isinstance(obj, traits.ValidityCheck)
    assert isinstance(pt, traits.Identity) and not isinstance(fe, traits.Double)
    for fn in (tz.double_and_add, tz.ltr_bin_mul):
        with pytest.raises(TypeError, match="Double"):
            fn(fe, sc)
    with pytest.raises(TypeError, match="Double"):
        tz.mul_by_cofactor(sc)
    jtraits = [n for n in dir(jz.traits) if n[0].isupper() and n not in ("Protocol", "Tuple")]
    assert all(hasattr(traits, n) for n in jtraits)


SURFACE = {
    "FieldElement": ["zero", "one", "minus_one", "two_pow_k", "from_ristretto255_scalar_bytes",
                     "to_ristretto255_scalar_bytes", "random", "__getitem__", "broadcast_to",
                     "__truediv__", "half", "__rshift__", "half_without_mod", "pow",
                     "legendre_symbol", "legendre_symbol_value", "mod_sqrt", "inv_sqrt",
                     "sqrt_ratio_i", "cmp", "__lt__", "__le__", "__gt__", "__ge__",
                     "is_zero", "is_positive", "abs", "is_even", "conditional_negate",
                     "select", "to_ints", "__repr__"],
    "Scalar": ["__add__", "__sub__", "__mul__", "__neg__", "square", "half", "inverse",
               "pow", "cmp", "__lt__", "__le__", "__gt__", "__ge__", "eq", "is_zero",
               "is_even", "select", "broadcast_to", "__rshift__", "half_without_mod",
               "mod_2_pow_k", "mods_2_pow_k", "zero", "one", "minus_one", "two_pow_k",
               "compute_naf", "compute_window_naf", "__repr__"],
    "EdwardsPoint": ["from_field_elements", "new_from_y_coord", "random", "new_random_point",
                     "mul_by_cofactor", "mul_by_pow_2", "mul_raw_int", "compress", "select",
                     "to_affine", "to_projective", "coset4", "field", "to_ints"],
    "RistrettoPoint": ["random", "double", "__getitem__", "is_valid", "coset4"],
    "ProjectivePoint": ["identity", "to_extended", "__add__", "__neg__", "__sub__", "double",
                        "__mul__", "eq", "is_valid", "new_from_y_coord", "new_random_point"],
    "AffinePoint": ["identity", "eq", "is_valid", "to_extended", "__neg__"],
    "CompressedEdwardsY": ["identity", "decompress", "eq"],
    "MontgomeryPoint": ["from_edwards", "u", "to_edwards", "eq"],
}


@pytest.mark.parametrize("cls", list(SURFACE))
def test_every_jax_name_and_method_is_ported(cls):
    assert set(jz.__all__) <= set(tz.__all__)
    assert all(hasattr(tz, n) for n in tz.__all__)
    assert {"Engine", "msm", "msm_sharded", "pad_msm", "parallel"} <= set(tz.__all__)
    assert set(jz.models.__all__) <= set(tz.models.__all__)
    missing = [m for m in SURFACE[cls] if not hasattr(getattr(tz, cls), m)]
    assert not missing and all(hasattr(getattr(jz, cls), m) for m in SURFACE[cls])


NEW_CONSTRUCTORS = {
    "FieldElement.from_int": lambda d: tz.FieldElement.from_int(1, device=d),
    "FieldElement.zero": lambda d: tz.FieldElement.zero(d),
    "FieldElement.one": lambda d: tz.FieldElement.one(d),
    "FieldElement.minus_one": lambda d: tz.FieldElement.minus_one(d),
    "FieldElement.two_pow_k": lambda d: tz.FieldElement.two_pow_k(3, d),
    "FieldElement.random": lambda d: tz.FieldElement.random(torch.Generator(), (2,), d),
    "Scalar.from_int": lambda d: tz.Scalar.from_int(1, device=d),
    "Scalar.zero": lambda d: tz.Scalar.zero(d),
    "Scalar.one": lambda d: tz.Scalar.one(d),
    "Scalar.minus_one": lambda d: tz.Scalar.minus_one(d),
    "Scalar.two_pow_k": lambda d: tz.Scalar.two_pow_k(3, d),
    "Scalar.random": lambda d: tz.Scalar.random(torch.Generator(), (2,), d),
    "EdwardsPoint.identity": lambda d: tz.EdwardsPoint.identity((2,), d),
    "EdwardsPoint.basepoint": lambda d: tz.EdwardsPoint.basepoint((2,), d),
    "ProjectivePoint.identity": lambda d: tz.ProjectivePoint.identity((2,), d),
    "AffinePoint.identity": lambda d: tz.AffinePoint.identity((2,), d),
    "CompressedEdwardsY.identity": lambda d: tz.CompressedEdwardsY.identity((2,), d),
    "RistrettoPoint.identity": lambda d: tz.RistrettoPoint.identity((2,), d),
    "RistrettoPoint.basepoint": lambda d: tz.RistrettoPoint.basepoint((2,), d),
    "CompressedRistretto.identity": lambda d: tz.CompressedRistretto.identity((2,), d),
    "RistrettoPoint.random": lambda d: tz.RistrettoPoint.random(torch.Generator(), (1,), d),
    "EdwardsPoint.new_random_point": lambda d: tz.EdwardsPoint.new_random_point(
        torch.Generator(), (1,), 4, d)[0],
    "interop.limbs_from_numpy": lambda d: tz.interop.limbs_from_numpy(
        np.zeros((1, 22), np.int32), d),
}


def _device_of(obj):
    for name in ("limbs", "X", "bytes", "point"):
        if hasattr(obj, name):
            return _device_of(getattr(obj, name))
    return obj.device


@pytest.mark.parametrize("name", list(NEW_CONSTRUCTORS))
def test_constructors_default_to_the_card(monkeypatch, name):
    """With no device named, a constructor uses the default device: the
    first CUDA card, and with none it raises, naming the CPU escape (no
    fallback); under use_device("cpu") or device="cpu" it lands on the
    CPU."""
    make = NEW_CONSTRUCTORS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with config.use_device(None):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(None)
        assert _device_of(make("cpu")) == torch.device("cpu")
    assert _device_of(make(None)) == torch.device("cpu")       # the module's default
    with config.use_device("cpu"):
        assert _device_of(make(None)) == torch.device("cpu")


def test_default_device_is_the_first_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with config.use_device(None):
        assert config.default_device() == torch.device("cuda", 0)
        assert config.resolve_device("cpu") == torch.device("cpu")
    assert config.default_device() == torch.device("cpu")
    # the serving Engine names its own device: the default does not move it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tz.Engine(batch=4)
    assert ted.EdwardsPoint.basepoint().X.device == torch.device("cpu")
