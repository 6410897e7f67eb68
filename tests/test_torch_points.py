"""PyTorch port: the point models of the library surface -- projective,
affine and compressed-y Edwards points, the reference's free
scalar-multiplication functions, Ristretto's random, double, order check
and cosets, and Montgomery points -- held against the JAX package on the
same seeded inputs and against the oracle, and the protocol sweeps of
tests/test_protocols.py on both packages.  Points compare by the oracle's
projective equality, encodings and masks exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zerocaf_tpu as jz
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from zerocaf_tpu import oracle as o
import zerocaf_tpu_torch as tz
from zerocaf_tpu_torch import interop
from zerocaf_tpu_torch.ops.kernels import field_kernels as fk

N = 4


def _limbs(vals):
    return np.stack([np.array(o.int_to_limbs(v % o.P), np.int32) for v in vals])


def _coords(pts, n=4):
    """Oracle points -> n numpy coordinate arrays [len, 22]."""
    return tuple(_limbs([p[i] for p in pts]) for i in range(n))


def _make(pkg, cls, pts, n=4):
    arrs = _coords(pts, n)
    if pkg is jz:
        return getattr(jz, cls)(*(jnp.asarray(a) for a in arrs))
    return getattr(tz, cls)(*interop.point_from_numpy(arrs, ncoords=n))


def _ints(c):
    """Canonical ints of a coordinate (jax array or tensor)."""
    a = np.asarray(c) if not isinstance(c, torch.Tensor) else c.numpy()
    return [o.limbs_to_int(r) % o.P for r in a.reshape(-1, 22)]


def _affine(pt):
    """A point of either package (any model) -> its lanes' affine (x, y)."""
    X, Y = _ints(pt.X), _ints(pt.Y)
    Z = _ints(pt.Z) if hasattr(pt, "Z") else [1] * len(X)
    return [o.point_to_affine((x, y, z, 0)) for x, y, z in zip(X, Y, Z)]


def _canon(v):
    if isinstance(v, (tuple, list)):
        return [_canon(x) for x in v]
    if hasattr(v, "X"):
        return _affine(v)
    if hasattr(v, "point"):
        return _affine(v.point)
    if hasattr(v, "to_ints"):
        return [int(x) for x in np.ravel(np.asarray(v.to_ints(), dtype=object))]
    if hasattr(v, "bytes"):
        return np.asarray(v.bytes).tolist()
    return np.asarray(v).tolist()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1201)
    ks = [int.from_bytes(rng.bytes(32), "little") % o.R for _ in range(3 * N)]
    P = [o.scalar_mul(o.BASEPOINT, k) for k in ks[:N]]
    Q = [o.scalar_mul(o.BASEPOINT, k) for k in ks[N:2 * N]]
    P[1] = o.point_add(P[1], o.FOUR_COSET_GROUP[1])         # a lane off the subgroup
    Q[2] = P[2]                                              # equal operands
    s = ks[2 * N:]
    s[0] = 0
    return dict(P=P, Q=Q, s=s, ks=ks)


def _scalar(pkg, vals):
    return pkg.Scalar.from_int(vals)


# --- projective and affine points ---------------------------------------------------

PROJECTIVE = {
    "add": (lambda p, a, b, s: a + b, lambda a, b, s: o.point_add(a, b)),
    "sub": (lambda p, a, b, s: a - b, lambda a, b, s: o.point_add(a, o.point_neg(b))),
    "neg": (lambda p, a, b, s: -a, lambda a, b, s: o.point_neg(a)),
    "double": (lambda p, a, b, s: a.double(), lambda a, b, s: o.point_double(a)),
    "mul": (lambda p, a, b, s: a * _scalar(p, s), lambda a, b, s: o.scalar_mul(a, s)),
    "to_extended": (lambda p, a, b, s: a.to_extended(), lambda a, b, s: a),
}


@pytest.mark.parametrize("name", list(PROJECTIVE))
def test_projective_point_matches_jax_and_oracle(inputs, name):
    fn, ora = PROJECTIVE[name]
    args = [_make(tz, "ProjectivePoint", inputs[k], 3) for k in "PQ"]
    got = _canon(fn(tz, *args, inputs["s"]))
    jargs = [_make(jz, "ProjectivePoint", inputs[k], 3) for k in "PQ"]
    assert got == _canon(fn(jz, *jargs, inputs["s"]))
    assert got == [o.point_to_affine(ora(a, b, s))
                   for a, b, s in zip(inputs["P"], inputs["Q"], inputs["s"])]


def test_projective_and_affine_predicates(inputs):
    """eq and is_valid of both models (one lane moved off the curve), the
    affine lift and negation, and the identities."""
    P, Q = inputs["P"], inputs["Q"]
    bad = list(P)
    bad[3] = (P[3][0], (P[3][1] + 1) % o.P, P[3][2], P[3][3])
    aff = [o.point_to_affine(p) for p in P]
    aff_bad = [o.point_to_affine(p) for p in bad]
    out = {}
    for pkg in (tz, jz):
        pp, qq, bb = (_make(pkg, "ProjectivePoint", x, 3) for x in (P, Q, bad))
        ap = _make(pkg, "AffinePoint", [(x, y) for x, y in aff], 2)
        ab = _make(pkg, "AffinePoint", [(x, y) for x, y in aff_bad], 2)
        out[pkg] = _canon((pp.eq(qq), bb.is_valid(), pp.is_valid(), ap.eq(ap), ab.is_valid(),
                           ap.to_extended(), -ap, pkg.ProjectivePoint.identity((2,)),
                           pkg.AffinePoint.identity((2,))))
    assert out[tz] == out[jz]
    want_eq = [o.point_eq(a, b) for a, b in zip(P, Q)]
    assert out[tz][:5] == [want_eq, [True] * 3 + [False], [True] * N, [True] * N,
                           [True] * 3 + [False]]
    assert out[tz][5] == aff and out[tz][6] == [((-x) % o.P, y) for x, y in aff]


# --- Edwards points ---------------------------------------------------------------

EDWARDS = {
    "mul_by_cofactor": (lambda p, a, s: a.mul_by_cofactor(),
                        lambda a, s: o.scalar_mul(a, 8)),
    "mul_by_pow_2": (lambda p, a, s: a.mul_by_pow_2(5), lambda a, s: o.scalar_mul(a, 32)),
    "mul_raw_int_r": (lambda p, a, s: a.mul_raw_int(o.R), lambda a, s: o.scalar_mul(a, o.R)),
    "mul_raw_int_wide": (lambda p, a, s: a.mul_raw_int(2**252 + 12345),
                         lambda a, s: o.scalar_mul(a, 2**252 + 12345)),
    "select": (lambda p, a, s: a.select([True, False, True, False], a.double()),
               lambda a, s: a),
    "to_affine": (lambda p, a, s: a.to_affine(), lambda a, s: a),
    "to_projective": (lambda p, a, s: a.to_projective(), lambda a, s: a),
    "coset4": (lambda p, a, s: tuple(a.coset4()), None),
}


@pytest.mark.parametrize("name", list(EDWARDS))
def test_edwards_point_matches_jax_and_oracle(inputs, name):
    fn, ora = EDWARDS[name]
    got = _canon(fn(tz, _make(tz, "EdwardsPoint", inputs["P"]), inputs["s"]))
    assert got == _canon(fn(jz, _make(jz, "EdwardsPoint", inputs["P"]), inputs["s"]))
    if name == "select":
        dbl = [o.point_to_affine(o.point_double(a)) for a in inputs["P"]]
        aff = [o.point_to_affine(a) for a in inputs["P"]]
        assert got == [aff[0], dbl[1], aff[2], dbl[3]]
    elif name == "coset4":
        assert got == [[o.point_to_affine(c[i]) for c in map(o.coset4, inputs["P"])]
                       for i in range(4)]
    else:
        assert got == [o.point_to_affine(ora(a, s)) for a, s in zip(inputs["P"], inputs["s"])]


def test_edwards_compress_decompress_matches_jax_and_oracle(inputs):
    """CompressedEdwardsY bytes equal the JAX package's and the oracle's;
    decoding gives the point back; invalid encodings (x^2 not a square)
    are masked, in both packages alike."""
    wires = {}
    for pkg in (tz, jz):
        wires[pkg] = np.asarray(_make(pkg, "EdwardsPoint", inputs["P"]).compress())
    assert np.array_equal(wires[tz], wires[jz])
    assert [w.tobytes() for w in wires[tz]] == [o.edwards_compress(p) for p in inputs["P"]]
    enc = wires[tz].copy()
    rng = np.random.default_rng(1202)
    enc[2] = rng.integers(0, 256, 32, dtype=np.uint8)
    while o.edwards_decompress(enc[2].tobytes()) is not None:
        enc[2] = rng.integers(0, 256, 32, dtype=np.uint8)
    got, ok = tz.CompressedEdwardsY(interop.bytes_from_numpy(enc)).decompress()
    jgot, jok = jz.CompressedEdwardsY(jnp.asarray(enc)).decompress()
    assert ok.tolist() == np.asarray(jok).tolist() == [True, True, False, True]
    lanes = [0, 1, 3]
    assert [_affine(got)[i] for i in lanes] == [_affine(jgot)[i] for i in lanes] == [
        o.point_to_affine(inputs["P"][i]) for i in lanes]
    ident, ok_i = tz.CompressedEdwardsY.identity((2,)).decompress()
    assert ok_i.all() and _affine(ident) == [(0, 1)] * 2
    assert tz.CompressedEdwardsY(torch.tensor(enc)).eq(
        tz.CompressedEdwardsY(torch.tensor(wires[tz]))).tolist() == [True, True, False, True]


def test_edwards_from_coordinates_matches_jax_and_oracle(inputs):
    """from_field_elements, new_from_y_coord (both signs, a lane whose
    x^2 is not a square), field and to_ints."""
    aff = [o.point_to_affine(p) for p in inputs["P"]]
    ys = [y for _, y in aff]
    ys[3] = next(y for y in range(2, 100) if o.point_from_y(y, 0) is None)
    out = {}
    for pkg in (tz, jz):
        arr = (lambda a: jnp.asarray(a)) if pkg is jz else torch.tensor
        x = pkg.FieldElement(arr(_limbs([a for a, _ in aff])))
        y = pkg.FieldElement(arr(_limbs(ys)))
        pt = pkg.EdwardsPoint.from_field_elements(x, y)
        res = [pt, pt.field("T")]
        for sign in (0, 1):
            q, ok = pkg.EdwardsPoint.new_from_y_coord(y, sign)
            res += [ok, q[:3]]
            qp, okp = pkg.ProjectivePoint.new_from_y_coord(y, sign)
            res += [okp, pkg.ProjectivePoint(qp.X[:3], qp.Y[:3], qp.Z[:3])]
        out[pkg] = _canon(res)
    assert out[tz] == out[jz]
    assert out[tz][0][:3] == aff[:3]
    assert out[tz][1][:3] == [x * y % o.P for x, y in aff[:3]]
    for i, sign in enumerate((0, 1)):
        assert out[tz][2 + 4 * i] == [True] * 3 + [False]
        assert out[tz][3 + 4 * i] == [o.point_to_affine(o.point_from_y(y, sign))
                                      for y in ys[:3]]
    pt = _make(tz, "EdwardsPoint", inputs["P"])
    X, Y, Z, T = pt.to_ints()
    assert list(X) == [p[0] for p in inputs["P"]] and list(T) == [p[3] for p in inputs["P"]]


# --- the free functions -------------------------------------------------------------

FREE = {
    "double_and_add": lambda p, pt, s: p.double_and_add(pt, s),
    "ltr_bin_mul": lambda p, pt, s: p.ltr_bin_mul(pt, s),
    "mul_by_cofactor": lambda p, pt, s: p.mul_by_cofactor(pt),
    "mul_by_pow_2": lambda p, pt, s: p.mul_by_pow_2(pt, 3),
    "binary_naf_mul": lambda p, pt, s: p.binary_naf_mul(pt, s),
    "window_naf_mul": lambda p, pt, s: p.window_naf_mul(s, 5),
}


@pytest.mark.parametrize("name", list(FREE))
def test_free_functions_match_jax_and_oracle(inputs, name):
    got = _canon(FREE[name](tz, _make(tz, "EdwardsPoint", inputs["P"]),
                            _scalar(tz, inputs["s"])))
    assert got == _canon(FREE[name](jz, _make(jz, "EdwardsPoint", inputs["P"]),
                                    _scalar(jz, inputs["s"])))
    P, s = inputs["P"], inputs["s"]
    want = {"mul_by_cofactor": [o.scalar_mul(p, 8) for p in P],
            "mul_by_pow_2": [o.scalar_mul(p, 8) for p in P],
            "window_naf_mul": [o.scalar_mul(o.BASEPOINT, k) for k in s]}.get(
        name, [o.scalar_mul(p, k) for p, k in zip(P, s)])
    assert got == [o.point_to_affine(p) for p in want]


# --- Ristretto and Montgomery -------------------------------------------------------

def test_ristretto_random_is_the_double_elligator_of_the_drawn_bytes():
    g = torch.Generator().manual_seed(1203)
    pts = tz.RistrettoPoint.random(g, (N,))
    raw = torch.randint(0, 256, (N, 64), generator=torch.Generator().manual_seed(1203),
                        dtype=torch.uint8).numpy()
    assert [w.tobytes() for w in pts.compress().numpy()] == [
        o.ristretto_compress(o.from_uniform_bytes(r.tobytes())) for r in raw]
    back, ok = tz.RistrettoPoint.decompress(pts.compress())
    assert ok.all() and back.eq(pts).all()


def test_ristretto_surface_matches_jax_and_oracle(inputs):
    """double, __getitem__, coset4 and is_valid on subgroup points, a point
    off the subgroup (P + a 4-torsion point) and Elligator points, which
    may lie off it.  coset4 adds the reference's first three listed coset
    points; the first, (1, 0), is not on the curve (a = -1), so the second
    representative encodes differently while the other three share one
    wire -- in both packages and the oracle."""
    uniform = np.random.default_rng(1204).integers(0, 256, (N, 64), dtype=np.uint8)
    ell = [o.from_uniform_bytes(u.tobytes()) for u in uniform]
    mixed = inputs["P"][:2] + ell[:2]
    out = {}
    for pkg in (tz, jz):
        rp = pkg.RistrettoPoint(_make(pkg, "EdwardsPoint", mixed))
        cos = [pkg.RistrettoPoint(c).compress() for c in rp.coset4()]
        out[pkg] = _canon((rp.double(), rp[1:3], rp.is_valid(), cos))
    assert out[tz] == out[jz]
    assert out[tz][0] == [o.point_to_affine(o.point_double(p)) for p in mixed]
    assert out[tz][1] == [o.point_to_affine(p) for p in mixed[1:3]]
    assert out[tz][2] == [o.ristretto_is_valid(p) for p in mixed]
    assert out[tz][2][:2] == [True, False]
    wires = [o.ristretto_compress(p) for p in mixed]
    assert [[bytes(w) for w in c] for c in out[tz][3]] == [
        [o.ristretto_compress(c[i]) for c in map(o.coset4, mixed)] for i in range(4)]
    for i in (0, 2, 3):
        assert [bytes(w) for w in out[tz][3][i]] == wires


def test_montgomery_matches_jax_and_oracle(inputs):
    """u = (Z + Y)/(Z - Y) (the identity to u = 0, through inverse(0) = 0),
    u(), eq, and the way back for both x signs."""
    pts = inputs["P"][:3] + [o.IDENTITY]
    out = {}
    for pkg in (tz, jz):
        m = pkg.MontgomeryPoint.from_edwards(_make(pkg, "EdwardsPoint", pts))
        back = [m.to_edwards(sign) for sign in (0, 1)]
        out[pkg] = _canon((m.bytes, m.u(), m.eq(m), back[0][1], back[0][0],
                           back[1][1], back[1][0]))
    assert out[tz] == out[jz]
    us = [o.edwards_to_montgomery_u(p) if p != o.IDENTITY else 0 for p in pts]
    assert out[tz][1] == us and out[tz][2] == [True] * 4
    for j, sign in enumerate((0, 1)):
        lifts = [o.point_from_y(o.montgomery_u_to_edwards_y(u), sign) for u in us]
        assert out[tz][3 + 2 * j] == [p is not None for p in lifts]
        assert [a for a, p in zip(out[tz][4 + 2 * j], lifts) if p is not None] == [
            o.point_to_affine(p) for p in lifts if p is not None]


def test_random_points_properties():
    """Random constructors cannot match JAX's streams.  EdwardsPoint.random
    is k B: on the curve and in the prime-order subgroup.  new_random_point
    lands on the curve (any coset), each point the lift of its own y with
    one of the two x signs; its projective form is the same point."""
    g = torch.Generator().manual_seed(1205)
    kb = tz.EdwardsPoint.random(g, (N,))
    ints = list(zip(*kb.to_ints()))
    assert kb.is_valid().all() and all(o.ristretto_is_valid(p) for p in ints)
    pt, ok = tz.EdwardsPoint.new_random_point(torch.Generator().manual_seed(1206), (N,))
    assert ok.all() and pt.is_valid().all()
    for x, y in _affine(pt):
        assert (x, y) in [o.point_to_affine(o.point_from_y(y, s)) for s in (0, 1)]
    pp, okp = tz.ProjectivePoint.new_random_point(torch.Generator().manual_seed(1206), (N,))
    assert okp.all() and _affine(pp) == _affine(pt)


# --- the protocol sweeps of tests/test_protocols.py, on both packages -------------

def test_protocol_sweeps_on_both_packages():
    """ECDH through Scalar and RistrettoPoint (ladder keys and shared
    secrets), then the field, scalar, group-law and Ristretto sweeps of
    tests/test_protocols.py, each run by both packages on the same inputs
    and checked against the oracle."""
    rng = np.random.default_rng(1207)
    n = N
    seeds = rng.integers(0, 256, (2, n, 64), dtype=np.uint8)
    fx = [int.from_bytes(rng.bytes(40), "little") % o.P for _ in range(2 * n)]
    sx = [int.from_bytes(rng.bytes(40), "little") % o.R for _ in range(2 * n)]
    uniform = rng.integers(0, 256, (n, 64), dtype=np.uint8)
    out = {}
    for pkg in (tz, jz):
        arr = (lambda a: jnp.asarray(a)) if pkg is jz else torch.tensor
        res = {}
        sa, sb = (pkg.Scalar.from_bytes_wide(arr(s)) for s in seeds)
        base = pkg.RistrettoPoint.basepoint((n,))
        pk_a, pk_b = base * sa, base * sb
        res["ecdh"] = [np.asarray((pk_b * sa).compress()), np.asarray((pk_a * sb).compress())]
        X, Y = (pkg.FieldElement.from_int(fx[i * n:(i + 1) * n]) for i in range(2))
        ok, r = X.square().mod_sqrt(0)
        res["field"] = [((X + Y) * (X - Y)).eq(X.square() - Y.square()),
                        (X * X.inverse()).eq(pkg.FieldElement.one().broadcast_to((n,))),
                        ok, r.eq(X) | r.eq(-X)]
        Xs, Ys = (pkg.Scalar.from_int(sx[i * n:(i + 1) * n]) for i in range(2))
        res["scalar"] = [((Xs + Ys) * (Xs - Ys)).eq(Xs.square() - Ys.square()),
                         (Xs * Xs.inverse()).eq(pkg.Scalar.one().broadcast_to((n,)))]
        P, Q = pk_a.point, pk_b.point                          # k1 B, k2 B
        res["group"] = [(P + Q).eq(Q + P), ((P + Q) + P).eq(P + (Q + P)),
                        (P + Q).eq(base.point * (sa + sb)), P.is_valid() & Q.is_valid()]
        pts = pkg.RistrettoPoint.from_uniform_bytes(arr(uniform))
        enc = pts.compress()
        back, okd = pkg.RistrettoPoint.decompress(enc)
        res["ristretto"] = [okd, back.eq(pts), np.asarray(back.compress()) == np.asarray(enc)]
        out[pkg] = {k: _canon(v) for k, v in res.items()}
    assert out[tz] == out[jz]
    ka = [int.from_bytes(s.tobytes(), "little") % o.R for s in seeds[0]]
    kb = [int.from_bytes(s.tobytes(), "little") % o.R for s in seeds[1]]
    shared = [list(o.ristretto_compress(o.scalar_mul(o.BASEPOINT, a * b % o.R)))
              for a, b in zip(ka, kb)]
    assert out[tz]["ecdh"] == [shared, shared]
    for k in ("field", "scalar", "group", "ristretto"):
        assert all(all(np.ravel(v)) for v in out[tz][k]), k


# --- on the card ---------------------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_ladder_kernel_at_253_windows_equals_plain(cuda):
    """mul_raw_int runs K3 at width 1 over 253 windows (RistrettoPoint's
    order check): the kernel equals its plain version's canonical limbs,
    and r P is the identity for subgroup points."""
    from zerocaf_tpu_torch.ops import limb

    pts = tz.RistrettoPoint.random(torch.Generator().manual_seed(1208), (256,), "cpu")
    kb = tz.EdwardsPoint.basepoint((256,), "cpu") * tz.Scalar.random(
        torch.Generator().manual_seed(1209), (256,), "cpu")
    for p in (pts.point, kb):
        bits = torch.tensor([(o.R >> i) & 1 for i in range(253)], dtype=torch.int32)
        bits = bits.expand(256, 253).contiguous()
        want = fk.scalar_mul_windowed_stepped_ref(p._tuple(), bits, 1)
        dev = tuple(c.to(cuda) for c in p._tuple())
        got = fk.scalar_mul_windowed_stepped(dev, bits.to(cuda), 1)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), limb.canonical_plain(w, limb.FIELD))
    assert tz.RistrettoPoint(tz.EdwardsPoint(*(c.to(cuda) for c in kb._tuple()))
                             ).is_valid().all()
