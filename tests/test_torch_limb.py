"""PyTorch port: the limb engine against the JAX package and the oracle.

Inputs are made with numpy from a fixed seed and fed to both packages.  All
arithmetic is integer, so every comparison is exact: canonical limbs, bytes
and masks (semi-reduced limbs are not unique), plus limb-for-limb equality
with the JAX package's own cascade reduction."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from zerocaf_tpu import oracle as o
from zerocaf_tpu.ops import limb as jl
from zerocaf_tpu_torch.ops import limb as tl

N = 16
SPECS = {"field": (jl.FIELD, tl.FIELD, o.P), "scalar": (jl.SCALAR, tl.SCALAR, o.R)}


def _vals(rng, n, m):
    return [int.from_bytes(rng.bytes(40), "little") % m for _ in range(n)]


def _limbs(vals):
    return np.stack([o.int_to_limbs(v) for v in vals]).astype(np.int32)


def _ints(limbs):
    return [o.limbs_to_int(r) for r in np.asarray(limbs)]


@pytest.fixture(scope="module", params=sorted(SPECS))
def data(request):
    jspec, tspec, m = SPECS[request.param]
    rng = np.random.default_rng(7 if request.param == "field" else 8)
    xs, ys = _vals(rng, N, m), _vals(rng, N, m)
    A, B = _limbs(xs), _limbs(ys)
    # semi-reduced, possibly negative operands: a*b - a (JAX limbs)
    A2 = np.asarray(jl.sub(jl.mul(jnp.asarray(A), jnp.asarray(B), jspec),
                           jnp.asarray(A)))
    x2 = [(x * y - x) % m for x, y in zip(xs, ys)]
    return dict(jspec=jspec, tspec=tspec, m=m, xs=xs, ys=ys, A=A, B=B, A2=A2, x2=x2)


def _t(a):
    return torch.tensor(np.asarray(a))


def _tcanon(x, d):
    return tl.canonical(x, d["tspec"]).numpy()


def test_mul_matches_jax_and_oracle(data):
    d = data
    for a, xs in ((d["A"], d["xs"]), (d["A2"], d["x2"])):
        got = tl.mul(_t(a), _t(d["B"]), d["tspec"])
        want = jl.canonical(jl.mul(jnp.asarray(a), jnp.asarray(d["B"]), d["jspec"]),
                            d["jspec"])
        assert np.array_equal(_tcanon(got, d), np.asarray(want))
        assert _ints(_tcanon(got, d)) == [x * y % d["m"] for x, y in zip(xs, d["ys"])]


def test_mul_limbs_equal_jax_cascade(data):
    """The port reduces by the all-VPU cascade: its limbs equal the JAX
    package's reduce_to_semi_cascade limb for limb."""
    d = data
    casc = jax.jit(lambda a, b: jl.reduce_to_semi_cascade(jl.school(a, b), d["jspec"]))
    for a in (d["A"], d["A2"]):
        got = tl.mul(_t(a), _t(d["B"]), d["tspec"]).numpy()
        assert np.array_equal(got, np.asarray(casc(jnp.asarray(a), jnp.asarray(d["B"]))))


def test_square_add_sub_neg(data):
    d = data
    a, b, m = d["A2"], d["B"], d["m"]
    x, y = d["x2"], d["ys"]
    cases = (
        (tl.square(_t(a), d["tspec"]), jl.square(jnp.asarray(a), d["jspec"]),
         [v * v % m for v in x]),
        (tl.add(_t(a), _t(b)), jl.add(jnp.asarray(a), jnp.asarray(b)),
         [(u + v) % m for u, v in zip(x, y)]),
        (tl.sub(_t(a), _t(b)), jl.sub(jnp.asarray(a), jnp.asarray(b)),
         [(u - v) % m for u, v in zip(x, y)]),
        (tl.neg(_t(a)), jl.neg(jnp.asarray(a)), [-v % m for v in x]),
    )
    for got, want, ints in cases:
        assert np.array_equal(_tcanon(got, d),
                              np.asarray(jl.canonical(want, d["jspec"])))
        assert _ints(_tcanon(got, d)) == ints


def test_add_sub_limbs_equal_jax(data):
    """add/sub/neg are one carry pass in both packages: same limbs."""
    d = data
    a, b = d["A2"], d["B"]
    assert np.array_equal(tl.add(_t(a), _t(b)).numpy(),
                          np.asarray(jl.add(jnp.asarray(a), jnp.asarray(b))))
    assert np.array_equal(tl.sub(_t(a), _t(b)).numpy(),
                          np.asarray(jl.sub(jnp.asarray(a), jnp.asarray(b))))
    assert np.array_equal(tl.neg(_t(a)).numpy(), np.asarray(jl.neg(jnp.asarray(a))))


def test_canonical_of_jax_semi_limbs(data):
    """canonical() is unique: the port maps the JAX package's semi-reduced
    limbs to exactly the JAX package's canonical limbs."""
    d = data
    semi = np.concatenate([d["A2"], -d["A2"], d["A2"] * 2])
    got = _tcanon(_t(semi), d)
    assert np.array_equal(got, np.asarray(jl.canonical(jnp.asarray(semi), d["jspec"])))
    assert _ints(got[:N]) == d["x2"]


def test_byte_codecs(data):
    d = data
    rng = np.random.default_rng(11)
    raw = rng.integers(0, 256, (N, 32), dtype=np.uint8)
    raw[0] = 0xFF                                  # 2^256 - 1, far above m
    raw[1] = np.frombuffer(d["m"].to_bytes(32, "little"), np.uint8)
    got = tl.from_bytes(_t(raw), d["tspec"])
    want = jl.from_bytes(jnp.asarray(raw), d["jspec"])
    assert np.array_equal(_tcanon(got, d), np.asarray(jl.canonical(want, d["jspec"])))
    assert _ints(_tcanon(got, d)) == [int.from_bytes(r.tobytes(), "little") % d["m"]
                                      for r in raw]
    enc = tl.to_bytes(_t(d["A2"]), d["tspec"]).numpy()
    assert np.array_equal(enc, np.asarray(jl.to_bytes(jnp.asarray(d["A2"]), d["jspec"])))
    assert [r.tobytes() for r in enc] == [v.to_bytes(32, "little") for v in d["x2"]]


def test_raw_limb_codecs_and_bits(data):
    d = data
    rng = np.random.default_rng(12)
    raw = rng.integers(0, 256, (N, 32), dtype=np.uint8)
    limbs = tl.bytes_to_limbs(_t(raw)).numpy()
    assert np.array_equal(limbs, np.asarray(jl.bytes_to_limbs(jnp.asarray(raw))))
    assert np.array_equal(tl.limbs_to_bytes(torch.tensor(limbs)).numpy(), raw)
    bits = tl.to_bits(_t(d["A2"]), d["tspec"], 253).numpy()
    assert np.array_equal(bits, np.asarray(jl.to_bits(jnp.asarray(d["A2"]), d["jspec"], 253)))


def test_eq_is_zero_geq(data):
    d = data
    a2, m = _t(d["A2"]), d["m"]
    canon = _t(_limbs(d["x2"]))
    assert tl.eq(a2, canon, d["tspec"]).all()
    assert not tl.eq(a2, tl.add(canon, tl.one_like(canon)), d["tspec"]).any()
    assert tl.is_zero(tl.sub(a2, canon), d["tspec"]).all()
    bound = tl.int_limbs(m // 2)
    ge = tl.geq_const(torch.tensor(_tcanon(a2, d)), bound).tolist()
    assert ge == [v >= m // 2 for v in d["x2"]]
    assert tl.canonical_geq(a2, bound, d["tspec"]).tolist() == ge


def test_pow_const_short_exponents(data):
    d = data
    for e in (0, 1, 2, 3, 65537):
        got = tl.pow_const(_t(d["A2"]), e, d["tspec"])
        assert _ints(_tcanon(got, d)) == [pow(v, e, d["m"]) for v in d["x2"]]


def test_int32_shift_and_mask_semantics():
    """The carry algebra needs arithmetic >> and two's-complement &."""
    x = torch.tensor([-1, -4096, -4097, 8191], dtype=torch.int32)
    assert (x >> 12).tolist() == [-1, -1, -2, 1]
    assert (x & 4095).tolist() == [4095, 0, 4095, 4095]


def test_limb_from_int_matches_jax():
    for spec_name in SPECS:
        jspec, tspec, m = SPECS[spec_name]
        for v in (0, 1, m - 1, m + 5, 3 ** 150):
            assert np.array_equal(tl.from_int(v, tspec).numpy(),
                                  np.asarray(jl.from_int(v, jspec)))


def test_inv_sqrt_chains_match_oracle():
    """inverse, Legendre, raw Tonelli root (bit-identical sign), mod_sqrt
    and the four cases of sqrt_ratio_i, against the oracle."""
    from zerocaf_tpu_torch.ops import inv_sqrt as isq

    rng = np.random.default_rng(13)
    xs = [0, 1, 4, o.P - 1] + [int.from_bytes(rng.bytes(40), "little") % o.P
                              for _ in range(6)]
    a = torch.tensor(_limbs(xs))
    inv = _ints(tl.canonical(isq.inverse(a), tl.FIELD))
    assert inv == [pow(x, o.P - 2, o.P) for x in xs]
    assert isq.legendre_is_qr(a).tolist() == [o.legendre_symbol(x) == 1 for x in xs]
    ok, raw = isq.sqrt_raw(a)
    assert ok.tolist() == [o.mod_sqrt_ts(x) is not None for x in xs]
    raw = _ints(tl.canonical(raw, tl.FIELD))
    assert [r for r, k in zip(raw, ok.tolist()) if k] == [
        o.mod_sqrt_ts(x) for x, k in zip(xs, ok.tolist()) if k]
    sign = torch.tensor([1, 0] * 5, dtype=torch.int32)
    ok, root = isq.mod_sqrt(a, sign)
    want = [o.mod_sqrt(x, int(s)) for x, s in zip(xs, sign)]
    assert [r for r, w in zip(_ints(tl.canonical(root, tl.FIELD)), want)
            if w is not None] == [w for w in want if w is not None]
    vs = xs[::-1]
    vs[1] = 0                                      # v == 0, u != 0
    ok, r = isq.sqrt_ratio_i(a, torch.tensor(_limbs(vs)))
    want = [o.sqrt_ratio_i(u, v) for u, v in zip(xs, vs)]
    assert ok.tolist() == [w[0] for w in want]
    assert _ints(tl.canonical(r, tl.FIELD)) == [w[1] for w in want]


def test_field_element_facade():
    from zerocaf_tpu_torch import FieldElement

    x, y = 3 ** 100 % o.P, 7 ** 90 % o.P
    fx, fy = FieldElement.from_int([x, 5]), FieldElement.from_int([y, 0])
    assert fx.shape == (2,)
    cases = ((fx + fy, [(x + y) % o.P, 5]), (fx - fy, [(x - y) % o.P, 5]),
             (-fx, [-x % o.P, o.P - 5]), (fx * fy, [x * y % o.P, 0]),
             (fx.square(), [x * x % o.P, 25]),
             (fx.inverse(), [pow(x, o.P - 2, o.P), pow(5, o.P - 2, o.P)]))
    for got, want in cases:
        assert _ints(got.canonical().limbs) == want
        assert [r.tobytes() for r in got.to_bytes().numpy()] == [
            w.to_bytes(32, "little") for w in want]
    assert (fx * fx.inverse()).eq(FieldElement.from_int([1, 1])).all()


@pytest.mark.parametrize("width", [43, 34, 23, 22, 13, 5, 1])
def test_reduce_to_semi_matches_jax(width):
    """On tests/test_field.py's column shapes (TestMxuFold): the port's
    reduce_to_semi (the cascade with the micro-fold) gives the canonical
    limbs of the JAX package's reduce_to_semi (its int8 fold matrix) and,
    limb for limb, its reduce_to_semi_cascade(micro_fold=True).  The semi
    limbs of the two reduce_to_semi are not always equal: with these seeds
    mod p they are on every row, mod r they differ on 22-30 of the 32 rows
    at widths 22 and up (another seed gave one differing row mod p at
    width 5).  The JAX package's "bit-identical" holds for the values."""
    rng = np.random.default_rng(196 + width)
    for jspec, tspec, m in SPECS.values():
        hi = min(2**29, 2**31 // width)
        cols = rng.integers(-(2**21), hi, size=(32, width)).astype(np.int32)
        if width > 3:  # |value| < 2^(12 (width + 1)), the fold's precondition
            cols[:, -3:] = rng.integers(-13, 4096, size=(32, 3)).astype(np.int32)
        got = tl.reduce_to_semi(torch.from_numpy(cols), tspec)
        want = jl.reduce_to_semi(jnp.asarray(cols), jspec)
        assert np.array_equal(tl.canonical(got, tspec).numpy(),
                              np.asarray(jl.canonical(want, jspec)))
        casc = jl.reduce_to_semi_cascade(jnp.asarray(cols), jspec, micro_fold=True)
        assert np.array_equal(got.numpy(), np.asarray(casc))
        assert got.abs().max() <= 4112
        vals = [sum(int(c) << (12 * i) for i, c in enumerate(row)) for row in cols]
        assert _ints(tl.canonical(got, tspec)) == [v % m for v in vals]
    assert tl.FOLD_LIMB == jl.FOLD_LIMB == 21
