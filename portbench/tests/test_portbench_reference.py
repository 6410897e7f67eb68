"""The benchmark's plain reference against the library's published vectors,
and the traffic generator's answers against the reference's direct
arithmetic.  CPU only, a few seconds."""

import numpy as np
import pytest

from portbench.reference import curve as ref
from portbench.traffic import Traffic

# k B for k = 0..15 (the Rust crate's ristretto.rs test vectors)
SMALL_MULTIPLES = [
    "0000000000000000000000000000000000000000000000000000000000000000",
    "0200000000000000000000000000000000000000000000000000000000000000",
    "abe4ea98eaaeda5a9c63879cb3c4d9b4a01ed31ac383acefd7ed49861e1a8002",
    "1064fe35b16525f90f1d2f7d3dc448ba31a118f136c53eed88c2e951f1832907",
    "a826cf66461dea21e51187dddd8753299b726a7d4217cb75758aefbf5a2d4f01",
    "4d2e0705a9b47d122f98bd74808d386cf1691bc5407af703dd0c4808038b7f07",
    "f3a3592fde5fa05a881b80b4e732b37c32c7f684a5be33cdb8b7bdaf53db6f04",
    "51626c7960da63010efc5e064e62962f158f59928914fc108257ec2653745e01",
    "d5f8144c1b04954291785be578633a79131752e82afb990bd4a25b41cbd49001",
    "1372ed81add54633970746cd4b38ceb8a3e538b916288ac3d7c0dfbd54a42b06",
    "a83d7a262a80926724a0beb75a5f26e9a622205e6a64730e14ce64c4b2acf704",
    "a6b2712a6e586ab552f7bcf438168304b8b8a3f3b2852a06ae183e6303406503",
    "7876266b939b889c1da827a76da5c220eb1ff934472d35de60c9e4c3528fcc06",
    "11a0f75ab351572b572c38bf073b076aa964cdff70d53ad7588174dae2729306",
    "64f2fb80b45fbf73793e9e8e509f98848ecdb452c98c83c55c5c31fb233d9907",
    "1de5afbe9fd279f1651306d8ac0f68f0cb2689609ccfe8db1636f9481a33e205",
]

# The Elligator map of this field element is the point with these affine
# coordinates, in the crate's five 52-bit limbs (ristretto.rs:679-720).
SAGE_INPUT = "2e2d7c6f887c81c1593f32e2fa31a7b65d4fbbf38f8ab3045ead22fc45743219"
SAGE_X = [520984263488427, 2866053035698784, 356812350072736, 1177086814167286,
          17585355348321]
SAGE_Y = [2224110940152212, 767723869121786, 2519083920383090, 3478258567033985,
          6072297619626]
SAGE_T = [3761248848988017, 3474827148739807, 3137090891116602, 1521420215868592,
          8052069914602]


def _limbs52(limbs):
    return sum(v << (52 * i) for i, v in enumerate(limbs))


def test_small_multiples():
    p = ref.IDENTITY
    for want in SMALL_MULTIPLES:
        assert ref.ristretto_compress(p).hex() == want
        p = ref.point_add(p, ref.BASEPOINT)


def test_two_b():
    two_b = ref.scalar_mul(ref.BASEPOINT, 2)
    assert ref.ristretto_compress(two_b).hex() == (
        "abe4ea98eaaeda5a9c63879cb3c4d9b4a01ed31ac383acefd7ed49861e1a8002")


def test_elligator_sage_vector():
    r0 = int.from_bytes(bytes.fromhex(SAGE_INPUT), "little") % ref.P
    got = ref.elligator(r0)
    want = (_limbs52(SAGE_X), _limbs52(SAGE_Y), 1, _limbs52(SAGE_T))
    assert ref.ristretto_compress(got) == ref.ristretto_compress(want)


def test_decode_round_trip_and_refusals():
    for k in (1, 2, 7, ref.R - 1, 2**200 + 12345):
        wire = ref.ristretto_compress(ref.scalar_mul(ref.BASEPOINT, k))
        assert ref.ristretto_compress(ref.ristretto_decompress(wire)) == wire
    s = int.from_bytes(bytes.fromhex(SMALL_MULTIPLES[2]), "little")
    assert ref.ristretto_decompress((s + ref.P).to_bytes(32, "little")) is None
    assert ref.ristretto_decompress(ref.fe_to_bytes(ref.P - 1)) is None   # negative


def test_basepoint_table():
    table = ref.BasepointTable()
    for k in (0, 1, 255, 256, 2**248 + 3, ref.R - 1):
        assert (ref.ristretto_compress(table.mul(k))
                == ref.ristretto_compress(ref.scalar_mul(ref.BASEPOINT, k)))


def test_msm_aggregate_is_the_sum():
    tr = Traffic({"batch": 48, "pool": 8}, {"op": "msm", "batches": 2}, 2**31 + 5)
    for i, b in enumerate(tr.batches):
        acc = ref.IDENTITY
        for wire, s in zip(b.args[0], b.args[1]):
            p = ref.ristretto_decompress(wire.tobytes())
            acc = ref.point_add(acc, ref.scalar_mul(p, int.from_bytes(s.tobytes(), "little")))
        assert tr.aggregate(i) == ref.ristretto_compress(acc)


def test_dh_answers_and_invalid_lanes():
    tr = Traffic({"batch": 256, "pool": 8},
                 {"op": "dh", "batches": 1, "invalid_every": 16}, 3)
    b = tr.batches[0]
    assert (~b.ok).sum() == 16
    for lane in range(0, 256, 5):
        p = ref.ristretto_decompress(b.args[1][lane].tobytes())
        assert (p is not None) == bool(b.ok[lane])
        if p is not None:
            s = int.from_bytes(b.args[0][lane].tobytes(), "little")
            assert tr.lane_answer(0, lane) == (ref.ristretto_compress(ref.scalar_mul(p, s)),)


@pytest.mark.parametrize("op", ["keygen", "hash_to_group"])
def test_lane_answers(op):
    tr = Traffic({"batch": 4, "pool": 4}, {"op": op, "batches": 1}, 11)
    raw = tr.batches[0].args[0][1].tobytes()
    if op == "keygen":
        sk = int.from_bytes(raw, "little") % ref.R
        want = (sk.to_bytes(32, "little"),
                ref.ristretto_compress(ref.scalar_mul(ref.BASEPOINT, sk)))
    else:
        want = (ref.ristretto_compress(ref.from_uniform_bytes(raw)),)
    assert tr.lane_answer(0, 1) == want


def test_same_seed_same_inputs():
    a = Traffic({"batch": 32, "pool": 4}, {"op": "msm", "batches": 2}, 2**33 + 1)
    b = Traffic({"batch": 32, "pool": 4}, {"op": "msm", "batches": 2}, 2**33 + 1)
    c = Traffic({"batch": 32, "pool": 4}, {"op": "msm", "batches": 2}, 2**33 + 2)
    assert all(np.array_equal(x, y) for x, y in zip(a.batches[1].args, b.batches[1].args))
    assert not np.array_equal(a.batches[1].args[1], c.batches[1].args[1])
    scalars = np.concatenate([bt.args[1] for bt in a.batches])
    assert all(int.from_bytes(s.tobytes(), "little") < ref.R for s in scalars)
