"""PyTorch port: kernels K1-K4.

On the CPU the plain PyTorch versions are held against the JAX package's
plain paths (which tests/test_pallas.py pins bit-exact to the Pallas
kernels) and the oracle.  The CUDA kernels are held against their plain
versions by the tests marked ``cuda``: they skip without a card.  The
kernels compute on the 8 x 32-bit core and write canonical limbs, compared
with the plain versions' canonical limbs.  Every comparison is exact
(integer arithmetic)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import canon_cases as cc
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from zerocaf_tpu import constants as JC
from zerocaf_tpu import oracle as o
from zerocaf_tpu.models import edwards as jed
from zerocaf_tpu.ops import limb as jl
from zerocaf_tpu.ops.pallas import field_kernels as jfk
from zerocaf_tpu_torch.models import ristretto as tri
from zerocaf_tpu_torch.ops import limb as tl
from zerocaf_tpu_torch.ops.kernels import build
from zerocaf_tpu_torch.ops.kernels import field_kernels as fk

N = 8
CHAIN = [JC.EXP_INV, JC.EXP_LEGENDRE, JC.EXP_SQRT, JC.EXP_SQRT_RATIO]
SHORT = [1, 2, 15, 16, 17, (1 << 32) + 1]


def _limbs(vals):
    return np.stack([o.int_to_limbs(v) for v in vals]).astype(np.int32)


def _ints(t, spec=tl.FIELD):
    return [o.limbs_to_int(r) for r in tl.canonical_plain(t, spec).numpy()]


@pytest.fixture(scope="module")
def elems():
    rng = np.random.default_rng(31)
    xs = [int.from_bytes(rng.bytes(40), "little") % o.P for _ in range(N)]
    ys = [int.from_bytes(rng.bytes(40), "little") % o.P for _ in range(N)]
    A, B = jnp.asarray(_limbs(xs)), jnp.asarray(_limbs(ys))
    semi = np.asarray(jl.sub(jl.mul(A, B, jl.FIELD), A))      # possibly negative
    vals = [(x * y - x) % o.P for x, y in zip(xs, ys)]
    return dict(semi=semi, vals=vals, B=np.asarray(B), ys=ys)


@pytest.fixture(scope="module")
def ladder_inputs():
    """Random prime-order points and canonical scalars, with the edge
    scalars 0, 1 and r - 1."""
    rng = np.random.default_rng(32)
    ks = [int.from_bytes(rng.bytes(32), "little") % o.R for _ in range(N)]
    ks[:3] = [0, 1, o.R - 1]
    pts = [o.scalar_mul(o.BASEPOINT, 1 + int(rng.integers(1 << 30))) for _ in range(N)]
    coords = [np.stack([o.int_to_limbs(p[c]) for p in pts]).astype(np.int32)
              for c in range(4)]
    bits = np.array([[(k >> i) & 1 for i in range(250)] for k in ks], np.int32)
    wins = np.array([[(k >> (4 * i)) & 15 for i in range(63)] for k in ks], np.int32)
    want = [o.ristretto_compress(o.scalar_mul(p, k)) for p, k in zip(pts, ks)]
    return dict(coords=coords, bits=bits, wins=wins, want=want)


def _tpt(coords):
    return tuple(torch.tensor(c) for c in coords)


def _wire(t_point):
    return [r.tobytes() for r in tri._compress(t_point).numpy()]


def _wire_of_jax(j_point):
    """JAX-package limbs, Ristretto-compressed by the port (whose encoder is
    pinned to the oracle and the reference vectors in test_torch_ristretto)."""
    return _wire(tuple(torch.tensor(np.asarray(c)) for c in j_point))


@pytest.fixture(scope="module")
def jax_windowed(ladder_inputs):
    """The JAX package's plain windowed path, compressed."""
    pt = tuple(jnp.asarray(c) for c in ladder_inputs["coords"])
    return _wire_of_jax(jed._scalar_mul_windowed(pt, jnp.asarray(ladder_inputs["wins"]), 4))


# --- K1 ---------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["field", "scalar"])
def test_mul_tiled_ref_matches_jax_and_oracle(elems, spec):
    jspec, tspec, m = {"field": (jl.FIELD, tl.FIELD, o.P),
                       "scalar": (jl.SCALAR, tl.SCALAR, o.R)}[spec]
    a, b = elems["semi"], elems["B"]
    got = fk.mul_tiled_ref(torch.tensor(a), torch.tensor(b), tspec)
    casc = jax.jit(lambda x, y: jl.reduce_to_semi_cascade(jl.school(x, y), jspec))
    assert np.array_equal(got.numpy(), np.asarray(casc(jnp.asarray(a), jnp.asarray(b))))
    want = jl.canonical(jl.mul(jnp.asarray(a), jnp.asarray(b), jspec), jspec)
    assert np.array_equal(tl.canonical_plain(got, tspec).numpy(), np.asarray(want))
    # the semi limbs' integer value (signed limbs) reduced mod m
    vals = [o.limbs_to_int(r) for r in a]
    assert _ints(got, tspec) == [v * y % m for v, y in zip(vals, elems["ys"])]


def test_mul_tiled_on_cpu_runs_the_plain_version(elems):
    a, b = torch.tensor(elems["semi"]), torch.tensor(elems["B"])
    before = fk.mul_tiled.launches
    assert torch.equal(fk.mul_tiled(a, b), fk.mul_tiled_ref(a, b))
    assert fk.mul_tiled.launches == before


@pytest.mark.parametrize("spec", ["field", "scalar"])
def test_mul_tiled_on_the_kernel_tests_operands(elems, spec):
    """The operands that test_mul_tiled_kernel_equals_plain gives K1 -- semi
    limbs, the same negated, one add deep, views one lane in -- give the
    oracle's products on the CPU: the plain version that the kernel is
    held against is right on each of them."""
    tspec, m = (tl.FIELD, o.P) if spec == "field" else (tl.SCALAR, o.R)
    semi, b = torch.tensor(elems["semi"]), torch.tensor(elems["B"])
    for x, y in ((semi, b), (-semi, b), (semi + b, -b), (semi[1:], b[1:])):
        want = [o.limbs_to_int(u) * o.limbs_to_int(v) % m
                for u, v in zip(x.numpy(), y.numpy())]
        assert _ints(fk.mul_tiled(x, y, tspec), tspec) == want


def _word_ints(words):
    """[n, 8] int32 words (uint32 bits) -> the n integers they spell."""
    w = words.numpy().astype(np.int64) & 0xFFFFFFFF
    return [sum(int(v) << (32 * i) for i, v in enumerate(r)) for r in w]


def test_limbs_to_words_spells_the_same_integers():
    """Canonical limbs -> the 8 little-endian 32-bit words of the same
    integer, at the edges of the words and of the limbs."""
    rng = np.random.default_rng(33)
    vals = [0, 1, 4095, 4096, (1 << 31) - 1, 1 << 31, (1 << 32) - 1, 1 << 32,
            (1 << 252) + 7, o.P - 1] + [int.from_bytes(rng.bytes(32), "little") % o.P
                                        for _ in range(N)]
    assert _word_ints(fk.limbs_to_words(torch.tensor(_limbs(vals)))) == vals


def test_core_words_are_the_montgomery_form(elems):
    """core_words of the limbs the engine makes (semi, negated, one add
    deep) is v R mod p (R = 2^256), the form the kernels' core and K6's
    table hold."""
    semi, b = torch.tensor(elems["semi"]), torch.tensor(elems["B"])
    for x in (semi, -semi, semi + b):
        want = [o.limbs_to_int(r) * (1 << 256) % o.P for r in x.numpy()]
        assert _word_ints(fk.core_words(x)) == want


# --- K2 ---------------------------------------------------------------------


@pytest.mark.parametrize("e", CHAIN + SHORT, ids=lambda e: hex(e)[:12])
def test_pow_tiled_ref_matches_jax_and_oracle(elems, e):
    got = fk.pow_tiled_ref(torch.tensor(elems["semi"]), e)
    want = jl.canonical(jl.pow_const(jnp.asarray(elems["semi"]), e, jl.FIELD), jl.FIELD)
    assert np.array_equal(tl.canonical_plain(got, tl.FIELD).numpy(), np.asarray(want))
    assert _ints(got) == [pow(v, e, o.P) for v in elems["vals"]]


def test_pow_tiled_ref_scalar_modulus(elems):
    vals = [v % o.R for v in elems["vals"]]
    got = fk.pow_tiled_ref(torch.tensor(_limbs(vals)), o.R - 2, tl.SCALAR)
    assert _ints(got, tl.SCALAR) == [pow(v, o.R - 2, o.R) for v in vals]


def test_pow_digits():
    assert fk.pow_digits(0x1F03) == [1, 15, 0, 3]
    with pytest.raises(ValueError):
        fk.pow_digits(0)


# --- K3 / K4 ----------------------------------------------------------------


def test_ladder_ref_matches_jax_ladder(ladder_inputs):
    """K3's plain version at width 1 == the JAX oblivious ladder
    (ed._scalar_mul), compared after Ristretto compression."""
    d = ladder_inputs
    got = _wire(fk.scalar_mul_windowed_stepped_ref(_tpt(d["coords"]),
                                                   torch.tensor(d["bits"]), 1))
    pt = tuple(jnp.asarray(c) for c in d["coords"])
    assert got == _wire_of_jax(jed._scalar_mul(pt, jnp.asarray(d["bits"])))
    assert got == d["want"]


@pytest.mark.parametrize("signed", [False, True], ids=["stepped_w4", "signed_w4"])
def test_windowed_refs_match_jax_windowed(ladder_inputs, jax_windowed, signed):
    d = ladder_inputs
    ref = (fk.scalar_mul_windowed_signed_ref if signed
           else fk.scalar_mul_windowed_stepped_ref)
    got = _wire(ref(_tpt(d["coords"]), torch.tensor(d["wins"]), 4))
    assert got == jax_windowed
    assert got == d["want"]


def test_fused_on_cpu_matches_jax_windowed(ladder_inputs, jax_windowed):
    """K10 (the unsigned windowed ladder as one program) on the CPU: its
    plain version, equal to the JAX package's windowed path at width 4."""
    d = ladder_inputs
    before = fk.scalar_mul_windowed_fused.launches
    got = fk.scalar_mul_windowed_fused(_tpt(d["coords"]), torch.tensor(d["wins"]), 4)
    assert fk.scalar_mul_windowed_fused.launches == before
    assert _wire(got) == jax_windowed == d["want"]
    with pytest.raises(ValueError, match="width"):
        fk.scalar_mul_windowed_fused(_tpt(d["coords"]), torch.tensor(d["wins"]), 5)


def test_signed_recode_matches_jax():
    w = np.random.default_rng(33).integers(0, 16, (N, 63)).astype(np.int32)
    got = fk._signed_recode(torch.tensor(w), 4).numpy()
    assert np.array_equal(got, np.asarray(jfk._signed_recode(jnp.asarray(w), 4)))


def test_ladder_wrapper_checks_its_inputs(ladder_inputs):
    d = ladder_inputs
    pt = _tpt(d["coords"])
    with pytest.raises(ValueError, match="windows"):
        fk.scalar_mul_windowed_signed(pt, torch.tensor(d["wins"][:4]), 4)
    with pytest.raises(TypeError, match="int32"):
        fk.scalar_mul_windowed_signed(pt, torch.tensor(d["wins"]).long(), 4)
    with pytest.raises(ValueError, match="width"):
        fk.scalar_mul_windowed_stepped(pt, torch.tensor(d["wins"]), 5)


# --- k_canonical: the observation boundary ----------------------------------

@pytest.mark.parametrize("mode", cc.MODES)
@pytest.mark.parametrize("modulus", ["p", "r"])
def test_canonical_tiled_plain_matches_python_ints(modulus, mode):
    """k_canonical's plain version (also what the wrapper runs on a CPU
    tensor, with no launch), in every mode, against Python integers on the
    edge set and the limb vectors with carry slack."""
    spec, m, bound = cc.MODULI[modulus]
    rows, vals = cc.cases(m, bound)
    x = torch.tensor(rows)
    kw = cc.mode_args(spec, m, bound, mode, vals)
    got = fk.canonical_tiled_ref(x, spec, mode, **kw)
    before = fk.canonical_tiled.launches
    assert torch.equal(fk.canonical_tiled(x, spec, mode, **kw), got)
    assert fk.canonical_tiled.launches == before
    assert got.dtype == {"limbs": torch.int32, "bytes": torch.uint8}.get(mode, torch.bool)
    assert got.tolist() == cc.expected(mode, vals, m, bound)


def test_canonical_tiled_checks_its_inputs():
    a = torch.zeros((4, 22), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        fk.canonical_tiled(a.long(), tl.FIELD, "limbs")
    with pytest.raises(ValueError, match="limb axis"):
        fk.canonical_tiled(a[:, :21], tl.FIELD, "bytes")
    with pytest.raises(ValueError, match="contiguous"):
        fk.canonical_tiled(torch.zeros((22, 4), dtype=torch.int32).t(), tl.FIELD, "zero")
    meta = torch.empty((4, 22), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="tensors on"):
        fk.canonical_tiled(a, tl.FIELD, "eq", other=meta)
    with pytest.raises(ValueError, match="shapes differ"):
        fk.canonical_tiled(a, tl.FIELD, "eq", other=a[:2])
    with pytest.raises(ValueError, match="mode must be"):
        fk.canonical_tiled(a, tl.FIELD, "sign")
    with pytest.raises(ValueError, match="second operand"):
        fk.canonical_tiled(a, tl.FIELD, "eq")
    with pytest.raises(ValueError, match="second operand"):
        fk.canonical_tiled(a, tl.FIELD, "zero", other=a)
    with pytest.raises(ValueError, match="bound"):
        fk.canonical_tiled(a, tl.FIELD, "geq")
    with pytest.raises(ValueError, match="bound"):
        fk.canonical_tiled(a, tl.FIELD, "geq", bound=tl.int_limbs(5)[:21])


# --- routing: CPU runs the plain version; anything else launches or raises ---


def test_wrappers_check_dtype_shape_contiguity_device():
    a = torch.zeros((4, 22), dtype=torch.int32)
    with pytest.raises(TypeError):
        fk.mul_tiled(a.long(), a.long())
    with pytest.raises(ValueError):
        fk.mul_tiled(a[:, :21], a[:, :21])
    with pytest.raises(ValueError):
        fk.mul_tiled(torch.zeros((22, 4), dtype=torch.int32).t(), a)
    meta = torch.empty((4, 22), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        fk.mul_tiled(meta, meta)


def test_cuda_route_raises_without_the_library(monkeypatch, tmp_path, ladder_inputs):
    """A call routed to the kernel raises when the library cannot be built;
    it never falls back to the plain version."""
    monkeypatch.setattr(fk, "_on_cpu", lambda t: False)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setenv("PATH", str(tmp_path))
    before = fk.launch_counts()
    a = torch.zeros((4, 22), dtype=torch.int32)
    pt = _tpt(ladder_inputs["coords"])
    calls = (lambda: fk.mul_tiled(a, a), lambda: fk.pow_tiled(a, JC.EXP_INV),
             lambda: fk.scalar_mul_windowed_stepped(
                 pt, torch.tensor(ladder_inputs["bits"]), 1),
             lambda: fk.scalar_mul_windowed_signed(
                 pt, torch.tensor(ladder_inputs["wins"]), 4),
             lambda: fk.padd_tiled(pt, pt),
             lambda: fk.fixed_base_mul_stepped(
                 torch.zeros((4, 32), dtype=torch.int32), 8, signed=True),
             lambda: fk.scalar_mul_windowed_fused(
                 pt, torch.tensor(ladder_inputs["wins"]), 4),
             lambda: fk.canonical_tiled(a, tl.FIELD, "bytes"))
    for call in calls:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
    assert fk.launch_counts() == before


# --- the CUDA kernels against their plain versions (need a card) -----------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["field", "scalar"])
def test_mul_tiled_kernel_equals_plain(cuda, elems, spec):
    """K1 on the core against its plain version's canonical limbs, at 200
    lanes (a ragged last block) and 32768 (the serving batch): semi limbs
    (a product minus a factor, possibly negative), the same limbs negated,
    one add deep, and views that start one lane in (not 16-byte aligned:
    the kernel's word-by-word tile copy)."""
    tspec = tl.FIELD if spec == "field" else tl.SCALAR
    for lanes in (200, 32768):
        reps = -(-lanes // N)
        semi = torch.tensor(np.tile(elems["semi"], (reps, 1))[:lanes], device=cuda)
        b = torch.tensor(np.tile(elems["B"], (reps, 1))[:lanes], device=cuda)
        for x, y in ((semi, b), (-semi, b), (semi + b, -b), (semi[1:], b[1:])):
            want = tl.canonical_plain(fk.mul_tiled_ref(x, y, tspec), tspec)
            assert torch.equal(fk.mul_tiled(x, y, tspec), want)


@pytest.mark.cuda
@pytest.mark.parametrize("e", CHAIN + SHORT, ids=lambda e: hex(e)[:12])
def test_pow_tiled_kernel_equals_plain(cuda, elems, e):
    a = torch.tensor(np.tile(elems["semi"], (25, 1)), device=cuda)
    assert torch.equal(fk.pow_tiled(a, e), tl.canonical_plain(fk.pow_tiled_ref(a, e), tl.FIELD))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 129, 1000])
def test_pow_tiled_kernel_mod_r_and_ragged_lanes(cuda, elems, lanes):
    """K2 modulo r (r - 2, the scalar inverse) and modulo p at lane counts
    that are not a multiple of the kernel's block: canonical limbs equal to
    the plain version's, and the oracle's powers."""
    rows = np.resize(elems["semi"], (lanes, 22))
    a = torch.tensor(rows, device=cuda)
    for e, spec, m in ((o.R - 2, tl.SCALAR, o.R), (JC.EXP_SQRT_RATIO, tl.FIELD, o.P)):
        got = fk.pow_tiled(a, e, spec)
        assert torch.equal(got, tl.canonical_plain(fk.pow_tiled_ref(a, e, spec), spec))
        vals = [o.limbs_to_int(r) % m for r in rows]
        assert [o.limbs_to_int(r) for r in got.cpu().numpy()] == [pow(v, e, m)
                                                                  for v in vals]


@pytest.mark.cuda
@pytest.mark.parametrize("signed,width", [(False, 1), (False, 4), (True, 4)])
def test_ladder_kernels_equal_plain(cuda, ladder_inputs, signed, width):
    d = ladder_inputs
    pt = tuple(torch.tensor(c, device=cuda) for c in d["coords"])
    win = torch.tensor(d["bits"] if width == 1 else d["wins"], device=cuda)
    kern, ref = ((fk.scalar_mul_windowed_signed, fk.scalar_mul_windowed_signed_ref)
                 if signed else (fk.scalar_mul_windowed_stepped,
                                 fk.scalar_mul_windowed_stepped_ref))
    got, want = kern(pt, win, width), ref(pt, win, width)
    assert all(torch.equal(g, tl.canonical_plain(w, tl.FIELD)) for g, w in zip(got, want))
    assert [r.tobytes() for r in tri._compress(got).cpu().numpy()] == d["want"]


@pytest.mark.cuda
def test_signed_kernel_drops_the_top_carry(cuda, ladder_inputs):
    """K4 on window vectors whose signed recode carries out of the top
    window (every window 15; the top window 8): the carry is dropped, as
    in the plain version and the JAX package's _signed_recode, so the
    first lane is -P."""
    d = ladder_inputs
    pt = tuple(torch.tensor(c, device=cuda) for c in d["coords"])
    wins = d["wins"].copy()
    wins[0] = 15
    wins[1, -1] = 8
    win = torch.tensor(wins, device=cuda)
    got = fk.scalar_mul_windowed_signed(pt, win, 4)
    want = fk.scalar_mul_windowed_signed_ref(pt, win, 4)
    assert all(torch.equal(g, tl.canonical_plain(w, tl.FIELD)) for g, w in zip(got, want))
    neg = o.point_neg(tuple(o.limbs_to_int(c[0]) for c in d["coords"]))
    assert _wire(tuple(g[:1].cpu() for g in got)) == [o.ristretto_compress(neg)]


@pytest.mark.cuda
def test_fused_kernel_equals_plain(cuda, ladder_inputs):
    d = ladder_inputs
    pt = tuple(torch.tensor(c, device=cuda) for c in d["coords"])
    win = torch.tensor(d["wins"], device=cuda)
    before = fk.scalar_mul_windowed_fused.launches
    got = fk.scalar_mul_windowed_fused(pt, win, 4)
    assert fk.scalar_mul_windowed_fused.launches == before + 1
    want = fk.scalar_mul_windowed_stepped_ref(pt, win, 4)
    assert all(torch.equal(g, tl.canonical_plain(w, tl.FIELD)) for g, w in zip(got, want))
    assert [r.tobytes() for r in tri._compress(got).cpu().numpy()] == d["want"]
