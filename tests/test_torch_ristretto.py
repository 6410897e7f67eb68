"""PyTorch port: Ristretto encode / decode / Elligator and the Edwards layer
against the reference vectors, the JAX package and the oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_oracle import RISTRETTO_SMALL_MULTIPLES
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from zerocaf_tpu import oracle as o
from zerocaf_tpu.models import ristretto as jri
from zerocaf_tpu_torch import (CompressedRistretto, EdwardsPoint, FieldElement,
                               RistrettoPoint, Scalar)
from zerocaf_tpu_torch.models import edwards as _ed
from zerocaf_tpu_torch.ops import limb as tl

SAGE_INPUT = "2e2d7c6f887c81c1593f32e2fa31a7b65d4fbbf38f8ab3045ead22fc45743219"


def _hex(wire):
    return [r.tobytes().hex() for r in wire.numpy()]


@pytest.mark.parametrize("route", ["ladder", "windowed"])
def test_small_multiple_vectors(route):
    """k*B for k = 0..15 through the ladder (K3's route) and the signed
    windows (K4's route) give the reference's 16 encodings."""
    k = Scalar.from_int(list(range(16)))
    B = RistrettoPoint.basepoint((16,))
    pt = (B * k).point if route == "ladder" else B.point.mul_windowed(k)
    assert _hex(RistrettoPoint(pt).compress()) == RISTRETTO_SMALL_MULTIPLES


def test_elligator_sage_vector():
    raw = bytes.fromhex(SAGE_INPUT)
    fe = FieldElement.from_bytes(torch.tensor(list(raw), dtype=torch.uint8))
    got = RistrettoPoint.elligator(fe).compress().numpy().tobytes()
    want = o.ristretto_compress(o.elligator_ristretto_flavor(o.fe_from_bytes(raw)))
    assert got == want


@pytest.fixture(scope="module")
def encodings():
    """Valid encodings and every class of invalid one."""
    rng = np.random.default_rng(41)
    valid = [bytes.fromhex(h) for h in RISTRETTO_SMALL_MULTIPLES[:6]]
    valid += [o.ristretto_compress(o.scalar_mul(o.BASEPOINT, int(k)))
              for k in rng.integers(1, 1 << 62, 4)]
    invalid = [
        o.fe_to_bytes(o.P - 1),                     # s negative
        (o.P + 2).to_bytes(32, "little"),           # s >= p, non-canonical
        bytes([0xFF] * 32),                         # far above p
        o.P.to_bytes(32, "little"),                 # s == p
    ]
    randoms = [rng.bytes(32) for _ in range(6)]      # mostly not on the group
    return np.frombuffer(b"".join(valid + invalid + randoms),
                         np.uint8).reshape(-1, 32).copy()


def test_decode_ok_masks_match_jax(encodings):
    pt, ok = RistrettoPoint.decompress(torch.tensor(encodings))
    (jx, jy, _, jt), jok = jri._decompress(jnp.asarray(encodings))
    assert np.array_equal(ok.numpy(), np.asarray(jok))
    assert ok[:10].all() and not ok[10:14].any()
    assert ok.tolist() == [o.ristretto_decompress(e.tobytes()) is not None
                           for e in encodings]
    # decoded coordinates are canonical values: equal limb for limb
    for mine, theirs in ((pt.point.X, jx), (pt.point.Y, jy), (pt.point.T, jt)):
        m = ok.numpy()
        assert np.array_equal(tl.canonical(mine, tl.FIELD).numpy()[m],
                              np.asarray(jri._l.canonical(theirs, jri._F))[m])
    # and re-encode to the input bytes
    again = pt.compress().numpy()
    assert np.array_equal(again[ok.numpy()], encodings[ok.numpy()])


def test_from_uniform_bytes_matches_oracle():
    b = np.random.default_rng(42).integers(0, 256, (4, 64), dtype=np.uint8)
    got = RistrettoPoint.from_uniform_bytes(torch.tensor(b)).compress().numpy()
    for i in range(4):
        assert got[i].tobytes() == o.ristretto_compress(
            o.from_uniform_bytes(b[i].tobytes()))


def test_group_ops_and_equality():
    B = RistrettoPoint.basepoint((2,))
    two = B + B
    three = two + B
    assert (three - B).eq(two).all()
    assert (-B + B).eq(RistrettoPoint.identity((2,))).all()
    assert not two.eq(three).any()
    e = EdwardsPoint.basepoint((2,))
    assert e.double().eq(two.point).all()
    mask = torch.tensor([True, False])
    mixed = EdwardsPoint(*_ed._select(mask, e._tuple(), _ed._identity_like(e._tuple())))
    assert mixed.eq(e).tolist() == [True, False]
    assert mixed.eq(EdwardsPoint.identity((2,))).tolist() == [False, True]
    assert e.double().is_valid().all() and three.point.is_valid().all()
    assert not EdwardsPoint(e.X, e.X, e.Z, e.T).is_valid().any()
    w = three.compress()
    assert _hex(w) == RISTRETTO_SMALL_MULTIPLES[3:4] * 2
    assert CompressedRistretto(w).eq(CompressedRistretto((B + two).compress())).all()
    back, ok = CompressedRistretto(w).decompress()
    assert ok.all() and back.eq(three).all()
