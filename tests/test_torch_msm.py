"""PyTorch port: single-device MSM (kernels K5, K7, K8, parallel/msm.py and
Engine.msm).

On the CPU the kernels' plain versions are held against the JAX package's
XLA paths (the scan route, ``_add``, ``_combine_windows``) and the oracle;
the Pallas MSM kernels are not run here.  The CUDA kernels are held against
their plain versions by the tests marked ``cuda``: they skip without a
card.  K5, K7's kernel and K8 write canonical limbs (the 8 x 32-bit core),
so they are compared with their plain versions' canonical limbs.  Every
comparison is exact: canonical limbs or bytes, or projective equality
through the oracle."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zerocaf_tpu import oracle as o
from zerocaf_tpu.models import edwards as jed
from zerocaf_tpu.scalar import Scalar as JScalar
from zerocaf_tpu_torch import EdwardsPoint, Engine, Scalar, pad_msm
from zerocaf_tpu_torch.models import ristretto as tri
from zerocaf_tpu_torch.ops import limb as tl
from zerocaf_tpu_torch.ops.kernels import field_kernels as fk
from zerocaf_tpu_torch.ops.kernels import msm_kernels as mk

# the packages' parallel/__init__ export the function msm over the module
jmsm = importlib.import_module("zerocaf_tpu.parallel.msm")
tmsm = importlib.import_module("zerocaf_tpu_torch.parallel.msm")

N = 16


def _coords(pts):
    """Oracle points -> 4 numpy [n, 22] int32 coordinate arrays."""
    return [np.stack([o.int_to_limbs(p[c] % o.P) for p in pts]).astype(np.int32)
            for c in range(4)]


def _tpt(coords):
    return tuple(torch.tensor(np.asarray(c)) for c in coords)


def _ints(t_point):
    """The port's point tuple -> oracle points (limbs may be signed)."""
    cols = [t.reshape(-1, 22).numpy() for t in t_point]
    return [tuple(o.limbs_to_int(c[i]) % o.P for c in cols) for i in range(len(cols[0]))]


def _wire(t_point):
    return [r.tobytes() for r in tri._compress(t_point).numpy().reshape(-1, 32)]


def _rand_scalars(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % o.R for _ in range(n)]


@pytest.fixture(scope="module")
def case():
    """16 points k_i * B and scalars s_i from a seed, as wire bytes, with the
    oracle's aggregate."""
    rng = np.random.default_rng(61)
    ks, ss = _rand_scalars(rng, N), _rand_scalars(rng, N)
    ss[:3] = [0, 1, o.R - 1]
    pts = [o.scalar_mul(o.BASEPOINT, k) for k in ks]
    wire = np.stack([np.frombuffer(o.ristretto_compress(p), np.uint8) for p in pts])
    sc = np.stack([np.frombuffer(s.to_bytes(32, "little"), np.uint8) for s in ss])
    total = sum(k * s for k, s in zip(ks, ss)) % o.R
    want = o.ristretto_compress(o.scalar_mul(o.BASEPOINT, total))
    return dict(ks=ks, ss=ss, pts=pts, wire=wire, sc=sc, want=want)


# --- K5 ---------------------------------------------------------------------


def test_padd_tiled_ref_matches_jax_add():
    rng = np.random.default_rng(62)
    p = [o.scalar_mul(o.BASEPOINT, k) for k in _rand_scalars(rng, 64)]
    q = [o.scalar_mul(o.BASEPOINT, k) for k in _rand_scalars(rng, 64)]
    q[:2] = [o.IDENTITY, p[1]]                         # identity and doubling
    got = fk.padd_tiled_ref(_tpt(_coords(p)), _tpt(_coords(q)))
    jp, jq = (tuple(jnp.asarray(c) for c in _coords(x)) for x in (p, q))
    want = jax.jit(jed._add)(jp, jq)
    assert _wire(got) == _wire(_tpt(want))
    assert _wire(got) == [o.ristretto_compress(o.point_add(a, b)) for a, b in zip(p, q)]
    before = fk.padd_tiled.launches
    assert all(torch.equal(a, b) for a, b in zip(
        fk.padd_tiled(_tpt(_coords(p)), _tpt(_coords(q))), got))
    assert fk.padd_tiled.launches == before


def _operand_layout(layout):
    """Four coordinate tensors of one K5 operand in a given memory layout,
    and whether K5 should read them in place."""
    rng = np.random.default_rng(70)
    base = torch.tensor(rng.integers(-4096, 4096, (4, 96, 22)).astype(np.int32))
    if layout == "lane_halves":        # the lane reduction's first round
        tbl = base.permute(1, 0, 2).contiguous().view(3, 32, 4, 22)
        return tuple(tbl[:, 16:, j] for j in range(4)), True
    if layout == "planes":             # a later round: halves of planes
        return tuple(base[j].view(3, 32, 22)[:, :8] for j in range(4)), True
    if layout == "columns":            # the scan's column views
        return tuple(base[j].view(24, 4, 22)[:, 3] for j in range(4)), True
    if layout == "one":
        return tuple(base[j, 5] for j in range(4)), True
    if layout == "limbs_strided":      # limbs not contiguous: copied
        t = base.permute(0, 2, 1).contiguous()
        return tuple(t[j].t() for j in range(4)), False
    # mixed: one coordinate with other strides than the rest: copied
    cols = [base[j].view(48, 2, 22)[:, 1] for j in range(4)]
    wide = torch.zeros((48, 3, 22), dtype=torch.int32)
    wide[:, 0] = cols[2]
    cols[2] = wide[:, 0]
    return tuple(cols), False


@pytest.mark.parametrize("layout", ["lane_halves", "planes", "columns", "one",
                                    "limbs_strided", "mixed"])
def test_padd_operand_addresses_every_lane(layout):
    """K5 reads lane l of a coordinate at its first element plus
    (l // inner) * so + (l % inner) * si: that address holds the lane's
    limbs in every layout, and the tables' views are not copied."""
    coords, in_place = _operand_layout(layout)
    n = coords[0].numel() // 22
    inner = coords[0].shape[-2] if coords[0].dim() > 1 else 1
    views, (so, si) = fk.padd_operand(coords, inner)
    lane = torch.arange(n)
    off = ((lane // inner) * so + (lane % inner) * si)[:, None] + torch.arange(22)
    for t, v in zip(coords, views):
        flat = torch.empty(0, dtype=torch.int32).set_(v.untyped_storage())
        assert torch.equal(flat[v.storage_offset() + off], t.reshape(n, 22))
        shared = v.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()
        assert shared == in_place


# --- signed digits, scans and totals against the JAX package ---------------


@pytest.mark.parametrize("c", [3, 4, 6])
def test_signed_digits_match_jax(c):
    rng = np.random.default_rng(63 + c)
    half = 1 << (c - 1)
    nwin = -(-251 // c)
    win = rng.integers(0, 1 << c, (12, nwin)).astype(np.int32)
    win[0, :] = half                                   # carry chains through halves
    win[1, :] = (1 << c) - 1
    win[2, :] = 0
    win[3, ::2] = half
    win[:, -1] = rng.integers(0, 2, 12)                # canonical top window
    mag, sgn = tmsm.signed_digits(torch.tensor(win), c)
    jmag, jsgn = jmsm.signed_digits(jnp.asarray(win), c)
    assert np.array_equal(mag.numpy(), np.asarray(jmag))
    assert np.array_equal(sgn.numpy(), np.asarray(jsgn))
    assert int(mag.max()) <= half


def test_seg_exclusive_scan_matches_jax():
    rng = np.random.default_rng(64)
    pts = [o.scalar_mul(o.BASEPOINT, k) for k in _rand_scalars(rng, 7)]
    starts = np.array([1, 0, 0, 1, 1, 0, 0], np.int32)
    got = tmsm._seg_exclusive_scan(_tpt(_coords(pts)), torch.tensor(starts))
    want = jmsm._seg_exclusive_scan(tuple(jnp.asarray(c) for c in _coords(pts)),
                                    jnp.asarray(starts))
    assert [o.point_eq(a, b) for a, b in zip(_ints(got), _ints(_tpt(want)))] == [True] * 7
    # against the definition: the sum of the segment's earlier elements
    acc = o.IDENTITY
    for i, p in enumerate(pts):
        acc = o.IDENTITY if starts[i] else acc
        assert o.point_eq(_ints(got)[i], acc)
        acc = o.point_add(acc, p)


def test_bucket_totals_match_jax():
    rng = np.random.default_rng(65)
    nwin, nb = 2, 6
    pts = [o.scalar_mul(o.BASEPOINT, k) for k in _rand_scalars(rng, nwin * nb)]
    tables = [c.reshape(nwin, nb, 22) for c in _coords(pts)]
    got = _ints(tmsm._bucket_totals(_tpt(tables), nb))
    want = _ints(_tpt(jmsm._bucket_totals(tuple(jnp.asarray(t) for t in tables), nb)))
    assert all(o.point_eq(a, b) for a, b in zip(got, want))
    w0 = o.IDENTITY
    for b in range(1, nb):
        w0 = o.point_add(w0, o.scalar_mul(pts[b], b))
    assert o.point_eq(got[0], w0)


# --- K7 ---------------------------------------------------------------------


def test_bucket_accum_all_ref_matches_oracle(case):
    """Per-lane tables of K7's plain version, summed over lanes, equal the
    oracle's bucket sums for every window and bucket."""
    c, k = 3, tmsm.DENSE_K
    nb, nwin = (1 << (c - 1)) + 1, -(-251 // c)
    win = Scalar.from_int(case["ss"]).windows(c, nwin)
    jwin = JScalar.from_int(case["ss"]).windows(c, nwin)
    assert np.array_equal(win.numpy(), np.asarray(jwin))
    mag, sgn = tmsm.signed_digits(win, c)
    jmag, jsgn = jmsm.signed_digits(jwin, c)
    assert np.array_equal(mag.numpy(), np.asarray(jmag))
    assert np.array_equal(sgn.numpy(), np.asarray(jsgn))
    d = torch.where(sgn, -mag, mag)                    # [N, nwin]
    dig = tmsm.dense_digits(win, c, nwin)
    ngrp = dig.shape[0]
    assert torch.equal(dig.reshape(-1, N)[:nwin], d.t())
    assert not dig.reshape(-1, N)[nwin:].any()
    lanes = mk.dense_lanes(N)
    pts = torch.stack(_tpt(_coords(case["pts"])))
    tbl = mk.bucket_accum_all(pts, dig, nb, lanes)
    assert tuple(tbl.shape) == (ngrp, k, nb, lanes, 4, 22)
    flat = tbl.reshape(ngrp * k, nb, lanes, 4, 22).numpy()
    dn = d.numpy()
    for w in range(ngrp * k):
        for b in range(nb):
            got = o.IDENTITY
            for t in range(lanes):
                e = tuple(o.limbs_to_int(flat[w, b, t, j]) % o.P for j in range(4))
                got = o.point_add(got, e)
            want = o.IDENTITY
            if b and w < nwin:
                for i in range(N):
                    if abs(dn[i, w]) == b:
                        p = case["pts"][i]
                        want = o.point_add(want, o.point_neg(p) if dn[i, w] < 0 else p)
            assert o.point_eq(got, want), (w, b)
    # bucket 0 is never written: it stays the identity limb for limb
    assert (flat[:, 0, :, :, :] == np.array([0, 1, 1, 0])[:, None] * np.eye(1, 22)).all()
    assert torch.equal(tbl, tl.canonical(tbl, tl.FIELD))   # canonical limbs


def test_bucket_accum_all_checks_its_inputs():
    pts = torch.zeros((4, 8, 22), dtype=torch.int32)
    dig = torch.zeros((2, 4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="digits per window"):
        mk.bucket_accum_all(pts, dig[..., :4], 5, 32)
    with pytest.raises(TypeError, match="int32"):
        mk.bucket_accum_all(pts, dig.long(), 5, 32)
    with pytest.raises(ValueError, match="points"):
        mk.bucket_accum_all(pts[:3], dig, 5, 32)
    # a window's table must fit the kernel's 32-bit offsets: nb lanes PT < 2^31
    with pytest.raises(ValueError, match="table entries"):
        mk.bucket_accum_all(pts, dig, 5, 1 << 23)


def _canonical(t):
    """True where every [..., 22] element of t is canonical: limbs in [0,
    4096) and value below p."""
    return torch.equal(t, tl.canonical(t, tl.FIELD))


def test_to_field32_ref_matches_oracle(case):
    """The prep's plain version: signed semi limbs (the decoder's, and
    negated) -> the 8 x 32 core's words of v R mod p, R = 2^256."""
    pts = tri._decompress(torch.tensor(case["wire"]))[0]
    pst = torch.stack((pts[0], tl.neg(pts[1]), pts[2], tl.neg(pts[3])))
    words = mk.to_field32_ref(pst).numpy().astype(np.int64) & 0xFFFFFFFF
    assert words.shape == (N, 4, 8)
    for i in range(N):
        for j in range(4):
            v = o.limbs_to_int(pst[j, i].numpy()) % o.P
            got = sum(int(w) << (32 * q) for q, w in enumerate(words[i, j]))
            assert got == v * 2**256 % o.P


def test_wide_lanes_fill_one_wave():
    """K11 launches only one window: its lanes fill about one wave of
    k_bucket_accum (on a CPU tensor, an H100's), with at least 32 points a
    lane; K12 keeps dense_lanes."""
    cpu = torch.device("cpu")
    wave = mk.wave_threads(cpu)
    assert wave == 132 * 4 * 128
    assert mk.wide_lanes(1 << 20, 1, cpu) == 1 << 15
    assert mk.wide_lanes(1 << 12, 1, cpu) == 1 << 7
    assert mk.wide_lanes(N, 1, cpu) == mk.dense_lanes(N) == 32
    for n in (1 << 14, 1 << 20, 1 << 22):
        for k in (1, 2):
            lanes = mk.wide_lanes(n, k, cpu)
            assert lanes & (lanes - 1) == 0 and lanes <= max(32, n // 32)
            assert lanes * k <= 2 * wave


# --- K8 ---------------------------------------------------------------------


def test_combine_tables_ref_matches_jax_combine_windows():
    rng = np.random.default_rng(66)
    nwin, c = 6, 4
    nb = (1 << (c - 1)) + 1
    ks = _rand_scalars(rng, nwin * nb)
    pts = [o.scalar_mul(o.BASEPOINT, k) for k in ks]
    tables = [x.reshape(nwin, nb, 22) for x in _coords(pts)]
    got = mk.combine_tables(_tpt(tables), nb, nwin, c)
    want = jmsm._combine_windows(tuple(jnp.asarray(t) for t in tables), c, nb)
    assert _wire(got) == _wire(_tpt(want))
    total = sum((1 << (c * w)) * b * ks[w * nb + b]
                for w in range(nwin) for b in range(1, nb)) % o.R
    assert _wire(got) == [o.ristretto_compress(o.scalar_mul(o.BASEPOINT, total))]


def test_combine_tables_tail_matches_jax_horner_stride():
    """K8's strided form (c ndev doublings a window, then tail doublings),
    the window-sharded combine of one rank: equal to the JAX package's
    _horner(_bucket_totals(...), c, stride=ndev) doubled tail times, and to
    the oracle."""
    rng = np.random.default_rng(76)
    nwin, c, ndev, rank = 3, 2, 3, 2
    nb = (1 << (c - 1)) + 1
    ks = _rand_scalars(rng, nwin * nb)
    pts = [o.scalar_mul(o.BASEPOINT, k) for k in ks]
    tables = [x.reshape(nwin, nb, 22) for x in _coords(pts)]
    got = mk.combine_tables(_tpt(tables), nb, nwin, c * ndev, tail=c * rank)
    want = jmsm._horner(jmsm._bucket_totals(tuple(jnp.asarray(t) for t in tables), nb),
                        c, stride=ndev)
    for _ in range(c * rank):
        want = jed._double(want)
    assert _wire(got) == _wire(_tpt(want))
    total = sum((1 << (c * (ndev * w + rank))) * b * ks[w * nb + b]
                for w in range(nwin) for b in range(1, nb)) % o.R
    assert _wire(got) == [o.ristretto_compress(o.scalar_mul(o.BASEPOINT, total))]


# --- the slice: Engine.msm --------------------------------------------------


@pytest.fixture(scope="module")
def port_engine():
    return Engine(batch=N, device="cpu")


def test_engine_msm_matches_jax_msm_and_oracle(case, port_engine):
    """The port's Engine.msm, the JAX package's scan-route msm on the same
    points and scalars (its XLA path, without the compile of a JAX
    engine's decode and encode), and the oracle give the same bytes."""
    wire, ok = port_engine.msm(torch.tensor(case["wire"]), torch.tensor(case["sc"]), c=4)
    jpts = jed.EdwardsPoint(*(jnp.asarray(c) for c in _coords(case["pts"])))
    jsum = jmsm.msm(jpts, JScalar.from_int(case["ss"]), c=4, dense=False)
    assert bool(ok)
    assert wire.numpy().tobytes() == case["want"]
    assert o.ristretto_compress(_ints(_tpt(jsum._tuple()))[0]) == case["want"]


def test_engine_msm_invalid_lane(case, port_engine):
    bad = case["wire"].copy()
    bad[5] = 0xFF                                      # non-canonical encoding
    _, ok = port_engine.msm(bad, case["sc"], c=4)
    assert not bool(ok)


def test_pad_msm_leaves_the_sum_unchanged(case, port_engine):
    n = N - 3
    p, s, n_valid = pad_msm(case["wire"][:n], case["sc"][:n], N)
    assert n_valid == n and p.shape == (N, 32) and not p[n:].any() and not s[n:].any()
    wire, ok = port_engine.msm(p, s, c=4)
    total = sum(k * x for k, x in zip(case["ks"][:n], case["ss"][:n])) % o.R
    assert bool(ok)
    assert wire.numpy().tobytes() == o.ristretto_compress(o.scalar_mul(o.BASEPOINT, total))


def test_engine_msm_ragged_batch_raises(case, port_engine):
    with pytest.raises(ValueError, match="pad_msm"):
        port_engine.msm(case["wire"][:5], case["sc"][:5])
    with pytest.raises(ValueError):
        pad_msm(case["wire"], case["sc"], N - 1)


def test_msm_routes_and_naive_agree(case):
    pts = EdwardsPoint(*_tpt(_coords(case["pts"])))
    s = Scalar.from_int(case["ss"])
    dense = tmsm.msm(pts, s, c=4, dense=True)
    scan = tmsm.msm(pts, s, c=4, dense=False)
    naive = tmsm.msm_naive(pts, s)
    for got in (dense, scan, naive):
        assert _wire(got._tuple()) == [case["want"]]
    assert tmsm._use_dense(N, None, None)
    assert not tmsm._use_dense(1 << 20, 10, None)           # tables too large
    with pytest.raises(ValueError, match="windows"):
        tmsm.msm(pts, s, c=1, dense=True)


def test_engine_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(batch=N)
    assert Engine(batch=N, device="cpu").device == torch.device("cpu")


# --- the CUDA kernels against their plain versions (need a card) -----------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_padd_tiled_kernel_equals_plain(cuda):
    rng = np.random.default_rng(67)
    p = [o.scalar_mul(o.BASEPOINT, k) for k in _rand_scalars(rng, 300)]
    q = [o.scalar_mul(o.BASEPOINT, k) for k in _rand_scalars(rng, 300)]
    tp, tq = (tuple(t.to(cuda) for t in _tpt(_coords(x))) for x in (p, q))
    tp = (-tp[0], tp[1], tp[2], -tp[3])                # negated: signed limbs
    got, want = fk.padd_tiled(tp, tq), fk.padd_tiled_ref(tp, tq)
    assert all(torch.equal(g, tl.canonical(w, tl.FIELD)) for g, w in zip(got, want))


@pytest.mark.cuda
def test_padd_tiled_kernel_reads_strided_views(cuda):
    """The lane reduction's operands: the two halves of per-lane tables
    [E, lanes, 4, 22], read in place (whole points, 16-byte loads)."""
    rng = np.random.default_rng(71)
    pts = [o.scalar_mul(o.BASEPOINT, k) for k in _rand_scalars(rng, 40)]
    cols = _coords([pts[i % 40] for i in range(5 * 64)])
    tbl = torch.stack(_tpt(cols), dim=1).to(cuda).view(5, 64, 4, 22)
    p = tuple(tbl[:, :32, j] for j in range(4))
    q = tuple(tbl[:, 32:, j] for j in range(4))
    got, want = fk.padd_tiled(p, q), fk.padd_tiled_ref(p, q)
    assert all(torch.equal(g, tl.canonical(w, tl.FIELD)) for g, w in zip(got, want))


@pytest.mark.cuda
def test_padd_tiled_kernel_reads_column_views(cuda):
    """The scan's operands (parallel/msm.py, _seg_exclusive_scan): strided
    column views of separate coordinate tensors, read coordinate by
    coordinate, not as whole points; 150 lanes end in a partial warp."""
    rng = np.random.default_rng(72)
    pts = [o.scalar_mul(o.BASEPOINT, k) for k in _rand_scalars(rng, 40)]
    cols = _coords([pts[i % 40] for i in range(300)])
    v = tuple(t.to(cuda).view(150, 2, 22) for t in _tpt(cols))
    v = (-v[0], v[1], v[2], -v[3])                      # negated: signed limbs
    p = tuple(c[:, 1] for c in v)
    q = tuple(c[:, 0] for c in v)
    got, want = fk.padd_tiled(p, q), fk.padd_tiled_ref(p, q)
    assert all(torch.equal(g, tl.canonical(w, tl.FIELD)) for g, w in zip(got, want))
    sums = [o.point_add(o.point_neg(pts[(2 * i + 1) % 40]), o.point_neg(pts[2 * i % 40]))
            for i in range(150)]
    assert all(o.point_eq(g, w) for g, w in zip(_ints(tuple(t.cpu() for t in got)), sums))


@pytest.mark.cuda
@pytest.mark.parametrize("c,lanes", [(3, 32), (6, 64)])
def test_bucket_accum_all_kernel_equals_plain(cuda, case, c, lanes):
    nb, k, ngrp, n = (1 << (c - 1)) + 1, 4, 3, 500
    rng = np.random.default_rng(68)
    pts = torch.stack(_tpt(_coords([case["pts"][i % N] for i in range(n)]))).to(cuda)
    dig = rng.integers(-(nb - 1), nb, (ngrp, k, n)).astype(np.int32)
    dig[rng.random(dig.shape) < 0.1] = 0
    dig = torch.tensor(dig, device=cuda)
    got = mk.bucket_accum_all(pts, dig, nb, lanes)
    assert _canonical(got)
    assert torch.equal(got, mk.bucket_accum_all_ref(pts, dig, nb, lanes))


@pytest.mark.cuda
def test_to_field32_kernel_equals_plain(cuda, case):
    """The prep kernel on signed semi limbs against its plain version word
    for word."""
    pts = tri._decompress(torch.tensor(case["wire"]))[0]
    pst = torch.stack((pts[0], tl.neg(pts[1]), pts[2], tl.neg(pts[3])))
    pst = pst.repeat(1, 40, 1).to(cuda)
    assert torch.equal(mk.to_field32(pst), mk.to_field32_ref(pst))


@pytest.mark.cuda
@pytest.mark.parametrize("nwin,c", [(42, 6), (6, 4)])
def test_combine_tables_kernel_equals_plain(cuda, nwin, c):
    rng = np.random.default_rng(69)
    nb = (1 << (c - 1)) + 1
    pts = [o.scalar_mul(o.BASEPOINT, k) for k in _rand_scalars(rng, nwin * nb)]
    tables = tuple(t.to(cuda).reshape(nwin, nb, 22) for t in _tpt(_coords(pts)))
    got = mk.combine_tables(tables, nb, nwin, c)
    want = mk.combine_tables_ref(tables, nb, nwin, c)
    assert all(torch.equal(g, tl.canonical(w, tl.FIELD)) for g, w in zip(got, want))


@pytest.mark.cuda
def test_combine_tables_kernel_strided(cuda):
    """K8 as one rank's share of the window-sharded combine: 11 windows,
    c ndev = 24 doublings a window, tail 18 (rank 3 of 4 at c = 6), on
    tables of signed lazy limbs; canonical limbs equal to the plain
    version's."""
    rng = np.random.default_rng(75)
    nwin, nb, c, tail = 11, 33, 24, 18
    pts = [o.scalar_mul(o.BASEPOINT, k) for k in _rand_scalars(rng, nwin * nb)]
    coords = _coords(pts)
    coords[0], coords[3] = -coords[0], -coords[3]       # -P, as negative limbs
    tables = tuple(t.to(cuda).reshape(nwin, nb, 22) for t in _tpt(coords))
    got = mk.combine_tables(tables, nb, nwin, c, tail=tail)
    want = mk.combine_tables_ref(tables, nb, nwin, c, tail=tail)
    assert all(torch.equal(g, tl.canonical(w, tl.FIELD)) for g, w in zip(got, want))


@pytest.mark.cuda
def test_engine_msm_on_the_card(cuda, case):
    wire, ok = Engine(batch=N).msm(case["wire"], case["sc"])
    assert bool(ok) and wire.cpu().numpy().tobytes() == case["want"]


# --- K9, K11, K12 and the fold: K7's kernel for one window group -----------


def _group_inputs(case, c, n=40, ngrp=3, k=4):
    rng = np.random.default_rng(72 + c)
    nb = (1 << (c - 1)) + 1
    pts = torch.stack(_tpt(_coords([case["pts"][i % N] for i in range(n)])))
    dig = rng.integers(-(nb - 1), nb, (ngrp, k, n)).astype(np.int32)
    dig[rng.random(dig.shape) < 0.1] = 0
    return pts, torch.tensor(dig), nb


def test_group_entries_equal_k7_restricted(case):
    """K9 on group g, K11 on one window and K12 on a pair give K7's tables
    for those windows limb for limb (plain versions, on the CPU)."""
    pts, dig, nb = _group_inputs(case, 4)
    lanes = 8
    allt = mk.bucket_accum_all(pts, dig, nb, lanes)
    for g in range(dig.shape[0]):
        assert torch.equal(mk.bucket_accum_k(pts, dig[g], nb, 4, lanes), allt[g])
    assert torch.equal(mk.bucket_accum(pts, dig[1, 2:3], nb, lanes), allt[1, 2:3])
    assert torch.equal(mk.bucket_accum2(pts, dig[2, 1:3], nb, lanes), allt[2, 1:3])
    assert torch.equal(mk.bucket_accum_k_ref(pts, dig[0], nb, 4, lanes), allt[0])
    assert torch.equal(mk.bucket_accum_ref(pts, dig[0, :1], nb, lanes), allt[0, :1])
    assert torch.equal(mk.bucket_accum2_ref(pts, dig[0, 2:], nb, lanes), allt[0, 2:])


@pytest.mark.parametrize("fold", [1, 3])
def test_fold_is_the_first_lane_rounds(case, fold):
    """fold=f leaves in lanes 0:lanes>>f what the first f rounds of the
    lane reduction give, so the reduced tables are equal limb for limb."""
    pts, dig, nb = _group_inputs(case, 4)
    lanes = 16
    plain = mk.bucket_accum_all(pts, dig, nb, lanes)
    folded = mk.bucket_accum_all(pts, dig, nb, lanes, fold=fold)
    for a, b in zip(tmsm._lane_tables(folded, fold), tmsm._lane_tables(plain)):
        assert torch.equal(a, b)
    one = mk.bucket_accum_k(pts, dig[1], nb, 4, lanes, fold=fold)
    assert torch.equal(one[:, :, : lanes >> fold], folded[1, :, :, : lanes >> fold])


def test_group_entries_check_their_inputs():
    pts = torch.zeros((4, 8, 22), dtype=torch.int32)
    dig = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\[1, n\]"):
        mk.bucket_accum(pts, dig, 5, 32)
    with pytest.raises(ValueError, match=r"\[2, n\]"):
        mk.bucket_accum2(pts, dig[:1], 5, 32)
    with pytest.raises(ValueError, match=r"\[4, n\]"):
        mk.bucket_accum_k(pts, dig, 5, 4, 32)
    with pytest.raises(ValueError, match="fold"):
        mk.bucket_accum_k(pts, dig, 5, 2, 32, fold=6)
    with pytest.raises(TypeError, match="int32"):
        mk.bucket_accum2(pts, dig.long(), 5, 32)


# --- the dense options ---------------------------------------------------------


DENSE_OPTIONS = {
    "k1": (dict(k=1), "bucket_accum"),
    "k2": (dict(k=2), "bucket_accum2"),
    "k4_per_group": (dict(k=4, single_call=False), "bucket_accum_k"),
    "fold2": (dict(fold=2), "bucket_accum_all"),
    "xla_combine": (dict(fused_combine=False), "bucket_accum_all"),
}


@pytest.fixture(scope="module")
def jax_scan_wire(case):
    """The JAX package's scan-route msm (its XLA path) on the case: the
    MSM's value does not depend on c, and c = 4 shares its compile with
    test_engine_msm_matches_jax_msm_and_oracle."""
    jpts = jed.EdwardsPoint(*(jnp.asarray(c) for c in _coords(case["pts"])))
    jsum = jmsm.msm(jpts, JScalar.from_int(case["ss"]), c=4, dense=False)
    return o.ristretto_compress(_ints(_tpt(jsum._tuple()))[0])


@pytest.fixture(scope="module")
def dense_default():
    """The default k=4 form's bytes, by c (filled by the first test)."""
    return {}


@pytest.mark.parametrize("c", [5, 6])
@pytest.mark.parametrize("option", list(DENSE_OPTIONS))
def test_msm_dense_options(case, jax_scan_wire, dense_default, monkeypatch, c,
                           option):
    """Every option of _msm_dense (k=1, k=2, per-group k=4, fold=2, the
    log-depth combine) gives the bytes of the default k=4 form, of the
    oracle and of the JAX package's scan-route msm, at c = 5 (51 windows:
    k = 2 and 4 pad the last group) and c = 6, and enters the tables
    through its own kernel: one call a window, pair or group.  The JAX
    package's interpreted Pallas _msm_dense is not run here (minutes at
    16 points on a CPU); its own tests hold its k = 1, 2 and 4 forms equal
    to one another and to its scan route (tests/test_msm.py)."""
    kw, entry = DENSE_OPTIONS[option]
    calls = {name: 0 for name in ("bucket_accum", "bucket_accum2",
                                  "bucket_accum_k", "bucket_accum_all",
                                  "combine_tables")}

    def spy(name):
        real = getattr(mk, name)

        def counted(*args, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)
        return counted

    for name in calls:
        monkeypatch.setattr(mk, name, spy(name))
    nwin = tmsm.nwin_for(c)
    pts = _tpt(_coords(case["pts"]))
    win = Scalar.from_int(case["ss"]).windows(c, nwin)
    got = _wire(tmsm._msm_dense(pts, win, c, nwin, **kw))
    per_entry = {"bucket_accum": nwin, "bucket_accum2": -(-nwin // 2),
                 "bucket_accum_k": -(-nwin // 4), "bucket_accum_all": 1}
    assert calls[entry] == per_entry[entry]
    assert sum(calls.values()) == calls[entry] + calls["combine_tables"]
    assert calls["combine_tables"] == (0 if option == "xla_combine" else 1)
    monkeypatch.undo()
    if c not in dense_default:
        dense_default[c] = _wire(tmsm._msm_dense(pts, win, c, nwin))
    assert got == dense_default[c] == [case["want"]] == [jax_scan_wire]


def test_msm_options_route_as_the_jax_package(case):
    """fused=True and signed=False take the scan route; dense=True with
    signed=False raises; every route gives the oracle's bytes."""
    pts = EdwardsPoint(*_tpt(_coords(case["pts"])))
    s = Scalar.from_int(case["ss"])
    for kw in (dict(c=5, fused=True), dict(c=4, signed=False),
               dict(c=4, fused=True, signed=False)):
        assert not tmsm._use_dense(N, kw["c"], None, kw.get("fused", False),
                                   kw.get("signed", True))
        assert _wire(tmsm.msm(pts, s, **kw)._tuple()) == [case["want"]]
    with pytest.raises(ValueError, match="signed"):
        tmsm.msm(pts, s, c=4, dense=True, signed=False)


def test_segmented_scan_points_matches_jax():
    rng = np.random.default_rng(73)
    pts = [o.scalar_mul(o.BASEPOINT, k) for k in _rand_scalars(rng, 9)]
    starts = np.array([1, 0, 0, 1, 1, 0, 0, 0, 1], np.int32)
    got = tmsm._segmented_scan_points(_tpt(_coords(pts)), torch.tensor(starts))
    want = jmsm._segmented_scan_points(tuple(jnp.asarray(c) for c in _coords(pts)),
                                       jnp.asarray(starts))
    assert _wire(got) == _wire(_tpt(want))
    acc = o.IDENTITY
    for i, p in enumerate(pts):
        acc = p if starts[i] else o.point_add(acc, p)
        assert o.point_eq(_ints(got)[i], acc)


def test_horner_stride_matches_jax():
    rng = np.random.default_rng(74)
    pts = [o.scalar_mul(o.BASEPOINT, k) for k in _rand_scalars(rng, 3)]
    got = tmsm._horner(_tpt(_coords(pts)), 2, stride=3)
    want = jmsm._horner(tuple(jnp.asarray(c) for c in _coords(pts)), 2, stride=3)
    assert _wire(got) == _wire(_tpt(want))
    total = o.IDENTITY
    for w, p in enumerate(pts):
        total = o.point_add(total, o.mul_by_pow_2(p, 6 * w))
    assert o.point_eq(_ints(tuple(t[None] for t in got))[0], total)


@pytest.mark.cuda
@pytest.mark.parametrize("fold", [0, 2])
def test_group_entry_kernels_equal_plain(cuda, case, fold):
    """K9 (with and without the fold's K5 rounds), K11 and K12 on the card
    against their plain versions, limb for limb."""
    pts, dig, nb = _group_inputs(case, 6, n=500, ngrp=1)
    pts, dig, lanes = pts.to(cuda), dig[0].to(cuda), 64
    got = mk.bucket_accum_k(pts, dig, nb, 4, lanes, fold=fold)
    assert _canonical(got)          # K7's kernel and K5 both write canonical limbs
    # the fold's K5 rounds on the card against K5's plain version: canonical
    want = tl.canonical(mk.bucket_accum_k_ref(pts, dig, nb, 4, lanes, fold=fold),
                        tl.FIELD)
    assert torch.equal(got, want)
    got = mk.bucket_accum_all(pts, dig[None], nb, lanes, fold=fold)
    want = mk.bucket_accum_all_ref(pts, dig[None], nb, lanes, fold=fold)
    assert torch.equal(got, tl.canonical(want, tl.FIELD))
    if fold == 0:
        for entry, ref, d in ((mk.bucket_accum, mk.bucket_accum_ref, dig[:1]),
                              (mk.bucket_accum2, mk.bucket_accum2_ref, dig[2:])):
            for lanes_ in (lanes, None):          # None: the wrapper's lanes
                got = entry(pts, d.contiguous(), nb, lanes_)
                assert _canonical(got)
                assert torch.equal(got, ref(pts, d, nb, lanes_))
