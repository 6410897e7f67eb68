"""PyTorch port: the fixed-base comb (K6) and its tables.

On the CPU the plain K6 is held against the JAX package -- its XLA combs
and, at width 11, its two-window packed Pallas kernel in interpret mode --
and the oracle, by canonical bytes.  Tables are built at widths 8 and 11
only (the served widths 13 and 14 take seconds to build).  The scalars
include k = 2^250 - r, whose top signed window makes the last mixed
addition a doubling at widths 8, 11, 13 and 14.  The CUDA kernel reads the
table in the 8 x 32-bit core's Montgomery form, which is held equal to the
22 x 12 table here, and is held against its plain version's canonical
limbs by the tests marked ``cuda``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from zerocaf_tpu import Scalar as JScalar
from zerocaf_tpu import oracle as o
from zerocaf_tpu.models import edwards as jed
from zerocaf_tpu.ops.pallas import field_kernels as jfk
from zerocaf_tpu_torch import EdwardsPoint, Scalar, interop
from zerocaf_tpu_torch.models import edwards as ed
from zerocaf_tpu_torch.models import ristretto as tri
from zerocaf_tpu_torch.ops import limb as tl
from zerocaf_tpu_torch.ops.kernels import field_kernels as fk

N = 16
COLLIDE = 2**250 - o.R           # canonical: 2^249 - (r - 2^249) < r
SPECIAL = [COLLIDE, 0, 1, o.R - 1]
TABLES = [(8, False), (8, True), (11, True)]
GLUES = [("rows", False), ("lanes", False), ("packed", False), ("packed2", False),
         ("rows", True)]


@pytest.fixture(scope="module", autouse=True)
def cold_cache(tmp_path_factory):
    """Every table of this module is built from the oracle into an empty
    cache directory."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ed, "CACHE_DIR", str(tmp_path_factory.mktemp("comb_cache")))
        mp.setattr(ed, "_FIXED_BASE_TABLES", {})
        mp.setattr(ed, "_COMB_DEVICE_TABLES", {})
        yield


@pytest.fixture(scope="module")
def scalars():
    rng = np.random.default_rng(41)
    ks = SPECIAL + [int.from_bytes(rng.bytes(32), "little") % o.R
                    for _ in range(N - len(SPECIAL))]
    want = [o.ristretto_compress(o.scalar_mul(o.BASEPOINT, k)) for k in ks]
    return dict(ks=ks, want=want, port=Scalar.from_int(ks), jax=JScalar.from_int(ks))


def _wire(pt):
    return [r.tobytes() for r in tri._compress(tuple(pt)).numpy()]


def _wire_of_jax(pt):
    return _wire(torch.tensor(np.asarray(c)) for c in pt)


@pytest.fixture(scope="module")
def jax_w8(scalars):
    """The JAX package's XLA combs at width 8, compressed."""
    w = scalars["jax"].windows(8, 32)
    return {False: _wire_of_jax(jed._fixed_base_mul(w, 8)),
            True: _wire_of_jax(jed._fixed_base_mul_signed(w, 8))}


# --- tables ---------------------------------------------------------------


@pytest.mark.parametrize("width,signed", TABLES)
def test_tables_equal_the_jax_package(width, signed):
    tbl = ed._fixed_base_table_signed(width) if signed else ed._fixed_base_table(width)
    want = (jed._fixed_base_table_signed(width) if signed
            else jed._fixed_base_table(width))
    assert tbl.dtype == np.int32 and tbl.shape == fk.comb_shape(width, signed)
    assert np.array_equal(tbl, want)
    # published to the port's own cache, and read back from it
    cached = ed.comb_cache_path(width, signed)
    assert cached.name == f"comb_niels_{'s_' if signed else ''}w{width}.npy"
    assert np.array_equal(np.load(cached), want)


def test_cache_rejects_a_stale_file(monkeypatch):
    path = ed.comb_cache_path(8, True)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, np.zeros((2, 3), np.int32))
    monkeypatch.setattr(ed, "_FIXED_BASE_TABLES", {})
    assert np.array_equal(ed._fixed_base_table_signed(8), jed._fixed_base_table_signed(8))
    assert np.load(path).shape == (32, 129, 3, 22)


@pytest.mark.parametrize("layout", ["rows", "packed", "core"])
def test_comb_table_from_numpy_round_trips(layout):
    arr = jed._fixed_base_table_signed(8)
    dev = interop.comb_table_from_numpy(arr, 8, True, layout=layout)
    assert torch.equal(dev, ed.comb_table(8, True, layout, "cpu"))
    assert dev.shape == (32, 129, fk.COMB_WORDS[layout]) and dev.is_contiguous()
    if layout == "core":
        rinv = pow(1 << 256, -1, o.P)
        back = np.array([o.int_to_limbs(int.from_bytes(w.tobytes(), "little") * rinv % o.P)
                         for w in dev.numpy().reshape(-1, 8)], dtype=np.int32)
        assert np.array_equal(back.reshape(arr.shape), arr)
    else:
        if layout == "packed":
            v = dev[..., :33].unflatten(-1, (3, 11))
            back = torch.cat([v & 4095, v >> 12], dim=-1)
        else:
            back = dev[..., :66].unflatten(-1, (3, 22))
        assert np.array_equal(back.numpy(), arr)
        assert not dev[..., 3 * (22 if layout == "rows" else 11):].any()


def test_comb_table_from_numpy_rejects_bad_tables():
    arr = jed._fixed_base_table_signed(8)
    with pytest.raises(ValueError, match="comb table"):
        interop.comb_table_from_numpy(arr[:, :-1], 8, True)
    with pytest.raises(ValueError, match="comb table"):
        interop.comb_table_from_numpy(arr.astype(np.int64), 8, True)
    with pytest.raises(ValueError, match="comb table"):
        interop.comb_table_from_numpy(arr, 8, False)
    bad = arr.copy()
    bad[3, 4, 1, 5] = 4096
    with pytest.raises(ValueError, match="canonical"):
        interop.comb_table_from_numpy(bad, 8, True)
    with pytest.raises(ValueError, match="layout"):
        interop.comb_table_from_numpy(arr, 8, True, layout="lanes")


# --- the plain K6 against the JAX package and the oracle -------------------


def test_plain_comb_w11_matches_jax_packed2_kernel(scalars):
    """Width 11: 23 windows (odd, which the TPU's two-window kernel pads),
    signed, packed table; the JAX package's Pallas kernel in interpret
    mode on 8 lanes."""
    n = 8
    got = _wire(fk.fixed_base_mul_stepped_ref(
        scalars["port"].windows(11)[:n], 11, signed=True, glue="packed2"))
    jw = JScalar.from_int(scalars["ks"][:n]).windows(11, 23)
    want = _wire_of_jax(jfk.fixed_base_mul_stepped(jw, 11, interpret=True,
                                                   signed=True, glue="packed2"))
    assert got == want == scalars["want"][:n]


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
@pytest.mark.parametrize("glue,prefetch", GLUES,
                         ids=[g + ("_prefetch" if p else "") for g, p in GLUES])
def test_plain_comb_w8_matches_jax_xla(scalars, jax_w8, signed, glue, prefetch):
    got = _wire(fk.fixed_base_mul_stepped(scalars["port"].windows(8), 8, signed=signed,
                                          glue=glue, prefetch=prefetch))
    assert got == jax_w8[signed] == scalars["want"]


def test_comb_layouts_give_equal_limbs(scalars):
    """The packed unpack gives the rows' limbs: both layouts agree limb for
    limb, not only canonically."""
    w = scalars["port"].windows(8)
    rows = fk.fixed_base_mul_stepped_ref(w, 8, signed=True, glue="rows")
    packed = fk.fixed_base_mul_stepped_ref(w, 8, signed=True, glue="packed2")
    assert all(torch.equal(a, b) for a, b in zip(rows, packed))


def test_comb_digits_are_taken_mod_2_to_the_width(scalars):
    w = scalars["port"].windows(8)
    got = fk.fixed_base_mul_stepped(w + (w % 3) * 256, 8, signed=True)
    assert _wire(got) == scalars["want"]


def test_madd_niels_adds_an_affine_entry():
    """The 7M block: B + entry(w=1, d=3) = (1 + 3 * 2^8) B."""
    tbl = ed._fixed_base_table(8)
    e = tuple(torch.tensor(tbl[1, 3, j][None]) for j in range(3))
    b = EdwardsPoint.basepoint((1,))._tuple()
    assert _wire(ed._madd_niels(b, e)) == [o.ristretto_compress(
        o.scalar_mul(o.BASEPOINT, 1 + 3 * 256))]


# --- routes and checks -------------------------------------------------------


def test_basepoint_mul_routes(monkeypatch, scalars):
    """width None: the signed comb at COMB_WIDTH_SIGNED on the packed table;
    an explicit width: the unsigned comb on the rows table."""
    calls = []
    real = fk.fixed_base_mul_stepped

    def spy(windows, width, signed=False, glue="rows", prefetch=False):
        calls.append((width, signed, fk.comb_layout(glue, prefetch)))
        return real(windows, width, signed, glue, prefetch)

    monkeypatch.setattr(fk, "fixed_base_mul_stepped", spy)
    monkeypatch.setattr(ed, "COMB_WIDTH_SIGNED", 8)
    s = scalars["port"]
    got_default = EdwardsPoint.basepoint_mul(s)
    got_w8 = EdwardsPoint.basepoint_mul(s, width=8)
    assert calls == [(8, True, "packed"), (8, False, "rows")]
    assert _wire(got_default._tuple()) == _wire(got_w8._tuple()) == scalars["want"]


def test_comb_wrapper_checks_its_inputs(scalars):
    w = scalars["port"].windows(8)
    with pytest.raises(ValueError, match="windows"):
        fk.fixed_base_mul_stepped(w[:, :-1], 8)
    with pytest.raises(TypeError, match="int32"):
        fk.fixed_base_mul_stepped(w.long(), 8)
    with pytest.raises(ValueError, match="glue"):
        fk.fixed_base_mul_stepped(w, 8, glue="xla")
    with pytest.raises(ValueError, match="width"):
        fk.fixed_base_mul_stepped(w, 1, signed=True)
    meta = torch.empty(w.shape, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        fk.fixed_base_mul_stepped(meta, 8)


@pytest.mark.parametrize("width,signed", TABLES)
def test_core_table_holds_the_limb_table(width, signed):
    """The kernel's table in the core's form (v R mod p, 8 words a
    coordinate, 24 an entry), converted back to limbs, is the 22 x 12
    table; every glue value reads it on CUDA."""
    core = ed.comb_table(width, signed, "core", "cpu").numpy()
    host = ed._comb_table_host(width, signed)
    assert core.shape == host.shape[:2] + (fk.COMB_WORDS["core"],)
    rinv = pow(1 << 256, -1, o.P)
    back = [o.int_to_limbs(int.from_bytes(w.tobytes(), "little") * rinv % o.P)
            for w in core.reshape(-1, 8)]
    assert np.array_equal(np.array(back, dtype=np.int32), host.reshape(-1, 22))
    assert {fk.comb_layout(g, pf, "cuda") for g, pf in GLUES} == {"core"}


def test_comb_on_cpu_runs_the_plain_version(scalars):
    w = scalars["port"].windows(8)
    before = fk.fixed_base_mul_stepped.launches
    got = fk.fixed_base_mul_stepped(w, 8, signed=True, glue="packed2")
    want = fk.fixed_base_mul_stepped_ref(w, 8, signed=True, glue="packed2")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fk.fixed_base_mul_stepped.launches == before


# --- the CUDA kernel against its plain version (needs a card) ---------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("width,signed,glue", [(8, True, "packed2"), (8, True, "rows"),
                                               (8, False, "rows"), (8, False, "packed"),
                                               (11, True, "packed2")])
def test_comb_kernel_equals_plain(cuda, scalars, width, signed, glue):
    w = scalars["port"].windows(width).repeat(40, 1).to(cuda)      # 640 lanes
    before = fk.fixed_base_mul_stepped.launches
    got = fk.fixed_base_mul_stepped(w, width, signed=signed, glue=glue)
    want = fk.fixed_base_mul_stepped_ref(w, width, signed=signed, glue=glue)
    assert fk.fixed_base_mul_stepped.launches == before + 1
    assert all(torch.equal(a, tl.canonical_plain(b, tl.FIELD)) for a, b in zip(got, want))
    assert _wire(c[:N].cpu() for c in got) == scalars["want"]
