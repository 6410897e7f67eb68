"""PyTorch port: the f32x29 limb backend and its selector, the field's
module constants, the recoder's limb codecs, profiling, the entry step and
its multi-rank dry run, the examples, and checkpoint.load's default device.

The same seeded inputs go through the JAX package and the port; values are
compared canonically (limbs, bytes, masks).  The dry run and the examples
run in background processes started with the module (one CPU thread each),
while the JAX comparisons compile here; their tests at the end read them.
"""

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse)
import __graft_entry__ as jentry
import zerocaf_tpu.field as jfield
from zerocaf_tpu import FieldElement as JFieldElement
from zerocaf_tpu import Scalar as JScalar
from zerocaf_tpu import config as jconfig
from zerocaf_tpu import native as jnative
from zerocaf_tpu import oracle as o
from zerocaf_tpu.ops import limb as jl
from zerocaf_tpu_torch import EdwardsPoint, FieldElement, Scalar, config
from zerocaf_tpu_torch import entry as tentry
from zerocaf_tpu_torch import field as tfield
from zerocaf_tpu_torch import recode
from zerocaf_tpu_torch.ops import limb as tl
from zerocaf_tpu_torch.ops.kernels import field_kernels as fk
from zerocaf_tpu_torch.parallel import checkpoint
from zerocaf_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parent.parent
N = 8          # lanes: one shape for every JAX call, so each compiles once
VALS = [0, 1, 5, o.P - 1, 123456789, 1 << 200, 3, 17]     # test_backend.py's
SPECS = [("field_f9", o.P), ("scalar_f9", o.R)]

# The background runs: the dry run at small sizes (the JAX package's 2^12
# scan points take about 13 s a rank here), then every example.
DRYRUN_CODE = ("from zerocaf_tpu_torch.entry import dryrun_multichip\n"
               "if __name__ == '__main__':\n"
               "    dryrun_multichip(2, device='cpu', n_scan=64, n_pod=32)\n")
EXAMPLES_CODE = """
import tempfile, torch
torch.set_num_threads(1)
from zerocaf_tpu_torch.models import edwards
from zerocaf_tpu_torch.examples import basic_ops, msm_demo, serving
edwards.COMB_WIDTH_SIGNED = 8                 # no width-14 table on a CPU
edwards.CACHE_DIR = tempfile.mkdtemp()
basic_ops.main(device="cpu", batch=8)
print("EXAMPLE basic_ops OK", flush=True)
msm_demo.main(device="cpu", n=16, c=4)
print("EXAMPLE msm_demo OK", flush=True)
serving.main(device="cpu", batch=8)
print("EXAMPLE serving OK", flush=True)
"""


@pytest.fixture(scope="module", autouse=True)
def _runs(request):
    """Start the dry run and the examples with the module, where a selected
    test reads them; yield their processes and an output cache."""
    if not any(item.module is request.module and "background" in item.fixturenames
               for item in request.session.items):
        yield {}, {}
        return
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as tmp:
        script = Path(tmp) / "dryrun.py"        # spawn needs a main module
        script.write_text(DRYRUN_CODE)
        procs = {name: subprocess.Popen(
            [sys.executable, *args], cwd=tmp, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for name, args in (("dryrun", [str(script)]),
                               ("examples", ["-c", EXAMPLES_CODE]))}
        out = {}
        try:
            yield procs, out
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                p.communicate()


@pytest.fixture
def background(_runs):
    return _runs


def _finished(background, name: str) -> str:
    procs, out = background
    if name not in out:
        text, _ = procs[name].communicate(timeout=600)
        out[name] = (procs[name].returncode, text)
    rc, text = out[name]
    assert rc == 0, text[-4000:]
    return text


def _spec(name):
    return getattr(tl, name.upper()), getattr(jl, name.upper())


def _rand_ints(rng, n, bound):
    return [int.from_bytes(rng.bytes(32), "little") % bound for _ in range(n)]


def _arrs(vals, tspec):
    """The same limbs as a port tensor and a JAX array."""
    arr = np.stack([o.int_to_limbs(v, n=tspec.nlimbs, w=tspec.wbits)
                    for v in vals]).astype(np.float32)
    return torch.as_tensor(arr), jnp.asarray(arr)


def _ints(t, tspec):
    """Canonical ints of port limbs (their canonical form, read back)."""
    c = tl.canonical_plain(t, tspec).to(torch.int64).numpy()
    return [o.limbs_to_int(row, w=tspec.wbits) for row in c]


def _jints(x, jspec):
    c = np.asarray(jl.canonical(x, jspec)).astype(np.int64)
    return [o.limbs_to_int(row, w=jspec.wbits) for row in c]


# ---------------------------------------------------------------------------
# The f32x29 limb engine against the JAX package and the oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,mod", SPECS, ids=[s for s, _ in SPECS])
def test_f9_ring_ops_match_jax(name, mod):
    tspec, jspec = _spec(name)
    assert (tspec.wbits, tspec.nlimbs, tspec.fold_limb, tspec.kernel_id) == \
        (jspec.wbits, jspec.nlimbs, jspec.fold_limb, None)
    rng = np.random.default_rng(1234)
    xs, ys = _rand_ints(rng, N, mod), _rand_ints(rng, N, mod)
    (X, jX), (Y, jY) = _arrs(xs, tspec), _arrs(ys, tspec)
    cases = [(tl.mul(X, Y, tspec), jl.mul(jX, jY, jspec),
              [a * b % mod for a, b in zip(xs, ys)]),
             (tl.square(X, tspec), jl.square(jX, jspec), [a * a % mod for a in xs]),
             (tl.add(X, Y), jl.add(jX, jY), [(a + b) % mod for a, b in zip(xs, ys)]),
             (tl.sub(X, Y), jl.sub(jX, jY), [(a - b) % mod for a, b in zip(xs, ys)]),
             (tl.neg(X), jl.neg(jX), [(-a) % mod for a in xs])]
    for got, jgot, want in cases:
        assert got.dtype == torch.float32 and got.shape == (N, 29)
        assert _ints(got, tspec) == _jints(jgot, jspec) == want
    with pytest.raises(TypeError, match="int32"):      # no kernel takes f32x29
        fk.mul_tiled(X, Y, tl.FIELD)


@pytest.mark.parametrize("name,mod", SPECS, ids=[s for s, _ in SPECS])
def test_f9_mul_chain_stays_semi(name, mod):
    """Five multiply-adds stay inside the JAX test's limb bound (2^17), so
    every schoolbook column stays below 2^24, and agree with the JAX
    package's chain."""
    tspec, jspec = _spec(name)
    rng = np.random.default_rng(5)
    xs, ys = _rand_ints(rng, N, mod), _rand_ints(rng, N, mod)
    (X, jX), (Y, jY) = _arrs(xs, tspec), _arrs(ys, tspec)
    acc, jacc, want = X, jX, list(xs)
    for _ in range(5):
        acc = tl.mul(tl.add(acc, X), Y, tspec)
        jacc = jl.mul(jl.add(jacc, jX), jY, jspec)
        want = [(a + x) * y % mod for a, x, y in zip(want, xs, ys)]
        assert acc.abs().max().item() < (1 << 17)
    assert _ints(acc, tspec) == _jints(jacc, jspec) == want


@pytest.mark.parametrize("name,mod", SPECS, ids=[s for s, _ in SPECS])
def test_f9_bytes_and_raw_decode_match_jax(name, mod):
    tspec, jspec = _spec(name)
    rng = np.random.default_rng(9)
    xs = _rand_ints(rng, N, mod)
    X, jX = _arrs(xs, tspec)
    got = tl.to_bytes(X, tspec).numpy()
    assert np.array_equal(got, np.asarray(jl.to_bytes(jX, jspec)))
    assert [r.tobytes() for r in got] == [v.to_bytes(32, "little") for v in xs]
    raw = rng.integers(0, 256, (N, 32), dtype=np.uint8)
    raw[0] = 0xFF                                   # 2^256 - 1
    E = tl.from_bytes(torch.as_tensor(raw), tspec)
    assert _ints(E, tspec) == _jints(jl.from_bytes(jnp.asarray(raw), jspec), jspec) \
        == [int.from_bytes(r.tobytes(), "little") % mod for r in raw]


@pytest.mark.parametrize("name,mod", SPECS, ids=[s for s, _ in SPECS])
def test_f9_pow_eq_cmp_bits_match_jax(name, mod):
    tspec, jspec = _spec(name)
    rng = np.random.default_rng(13)
    xs = _rand_ints(rng, N, mod)
    ys = xs[:4] + _rand_ints(rng, N - 4, mod)
    (X, jX), (Y, jY) = _arrs(xs, tspec), _arrs(ys, tspec)
    assert _ints(tl.pow_const(X, 65537, tspec), tspec) == \
        _jints(jl.pow_const(jX, 65537, jspec), jspec) == [pow(a, 65537, mod) for a in xs]
    Ys = tl.sub(tl.add(Y, X), X)                    # the same values, other limbs
    eq = tl.eq(X, Ys, tspec).numpy()
    assert eq.tolist() == np.asarray(jl.eq(jX, jY, jspec)).tolist() == \
        [a == b for a, b in zip(xs, ys)]
    assert tl.cmp(X, Ys, tspec).tolist() == np.asarray(jl.cmp(jX, jY, jspec)).tolist() \
        == [(a > b) - (a < b) for a, b in zip(xs, ys)]
    bits = tl.to_bits(X, tspec, 256)
    assert bits.dtype == torch.int32
    assert np.array_equal(bits.numpy(), np.asarray(jl.to_bits(jX, jspec, 256)))
    assert bits.tolist() == [[(v >> i) & 1 for i in range(256)] for v in xs]


# ---------------------------------------------------------------------------
# tests/test_backend.py's behaviours through the port's facades
# ---------------------------------------------------------------------------


def _e2e(FE, SC, spec_of):
    """test_backend.py's flow on either package: field a b + a - b, inverse,
    sqrt_ratio_i and bytes; scalar s t + s and bytes.  Checks the oracle and
    returns the canonical results for a cross-package comparison."""
    a = FE.from_int(np.array(VALS, dtype=object))
    b = FE.from_int(np.array(VALS[::-1], dtype=object))
    s = SC.from_int(np.array(VALS, dtype=object))
    t = SC.from_int(np.array(VALS[::-1], dtype=object))
    out = {"spec": (spec_of(a), spec_of(s)), "nlimbs": a.limbs.shape[-1]}
    out["field"] = list((a * b + a - b).to_ints())
    assert out["field"] == [(x * y + x - y) % o.P for x, y in zip(VALS, VALS[::-1])]
    out["inverse"] = list(a.inverse().to_ints())
    assert out["inverse"] == [pow(x, o.P - 2, o.P) for x in VALS]
    ok, r = a.sqrt_ratio_i(FE.one().broadcast_to((len(VALS),)))
    out["ok"], out["root"] = np.asarray(ok).tolist(), list(r.to_ints())
    for x, k, root in zip(VALS, out["ok"], out["root"]):
        if x == 0:
            assert k and root == 0
        elif pow(x, (o.P - 1) // 2, o.P) == 1:
            assert k and pow(int(root), 2, o.P) == x % o.P
        else:
            assert not k
    out["bytes"] = np.asarray(a.to_bytes()).tolist()
    assert [int.from_bytes(bytes(row), "little") for row in out["bytes"]] == \
        [v % o.P for v in VALS]
    out["scalar"] = list((s * t + s).to_ints())
    assert out["scalar"] == [(x * y + x) % o.R for x, y in zip(VALS, VALS[::-1])]
    out["sbytes"] = np.asarray(s.to_bytes()).tolist()
    assert [int.from_bytes(bytes(row), "little") for row in out["sbytes"]] == \
        [v % o.R for v in VALS]
    return out


def test_default_backend_i32x22():
    assert config.get_backend() == "i32x22" and config.DEFAULT.backend == "i32x22"
    assert config.BACKEND_NAMES == jconfig.BACKEND_NAMES
    got = _e2e(FieldElement, Scalar, lambda v: v.spec)
    assert got["spec"] == (tl.FIELD, tl.SCALAR) and got["nlimbs"] == 22
    assert "backend=field" in repr(FieldElement.one())


def test_f32x29_backend_end_to_end_matches_jax():
    with config.use_backend("f32x29"):
        assert config.get_backend() == "f32x29"
        got = _e2e(FieldElement, Scalar, lambda v: v.spec)
        one = FieldElement.one()
    assert config.get_backend() == "i32x22"
    assert got["spec"] == (tl.FIELD_F9, tl.SCALAR_F9) and got["nlimbs"] == 29
    assert one.limbs.dtype == torch.float32 and "field_f9" in repr(one)
    with jconfig.use_backend("f32x29"):
        want = _e2e(JFieldElement, JScalar, lambda v: v.spec.name)
    del got["spec"], want["spec"]
    assert got == want


def test_cross_backend_byte_agreement_and_points_stay_i32x22():
    """Both backends give the same canonical bytes; a point multiplied by
    an f32x29 scalar stays on i32x22 (the ladder reads the scalar's bits)."""
    a1 = FieldElement.from_int(np.array(VALS, dtype=object))
    with config.use_backend("f32x29"):
        a2 = FieldElement.from_int(np.array(VALS, dtype=object))
        k = Scalar.from_int([7, o.R - 1])
        pt = EdwardsPoint.basepoint((2,)) * k
    assert torch.equal((a1 * a1 + a1).to_bytes(), (a2 * a2 + a2).to_bytes())
    assert pt.X.dtype == torch.int32 and pt.X.shape == (2, 22)
    for lane, kk in enumerate((7, o.R - 1)):
        got = tuple(int(c[lane]) for c in pt.to_ints())
        assert o.point_eq(got, o.scalar_mul(o.BASEPOINT, kk))


def test_explicit_spec_override():
    """A spec passed explicitly wins over the active backend."""
    a = FieldElement.from_int(7, spec=tl.FIELD_F9)
    assert a.spec is tl.FIELD_F9 and a.limbs.shape[-1] == 29
    assert int(a.square().to_ints()) == 49
    with config.use_backend("f32x29"):
        s, ok = Scalar.from_bytes(torch.tensor([[9] + [0] * 31], dtype=torch.uint8),
                                  spec=tl.SCALAR)
    assert s.spec is tl.SCALAR and bool(ok.all())
    assert int(s.half().half_without_mod().to_ints()[0]) == o.shalf(9) >> 1


def test_unknown_backend_rejected():
    with pytest.raises(ValueError):
        config.set_backend("u64")
    assert config.get_backend() == "i32x22"


def test_msm_defaults_match_jax():
    from zerocaf_tpu.parallel.msm import DEFAULT_C, DENSE_FOLD
    from zerocaf_tpu_torch.parallel.msm import DEFAULT_C as C, DENSE_FOLD as F

    assert (C, F) == (DEFAULT_C, DENSE_FOLD) == (8, 0)


def test_field_module_constants_match_jax():
    names = ("EDWARDS_D", "EDWARDS_A", "SQRT_M1", "INV_SQRT_A", "MINUS_SQRT_A",
             "INV_SQRT_A_MINUS_D", "SQRT_AD_MINUS_ONE", "ONE_MINUS_D_SQ",
             "D_MINUS_ONE_SQ")
    for name in names:
        mine = getattr(tfield, name)
        assert isinstance(mine, FieldElement) and mine.limbs.device.type == "cpu"
        assert mine.to_ints() == getattr(jfield, name).to_ints(), name
    with pytest.raises(AttributeError):
        tfield.NOT_A_CONSTANT


@pytest.mark.cuda
def test_f9_product_ignores_tf32():
    """The f32x29 product on the card is exact whatever the float32 matmul
    settings: it gives the same bytes as the int32 backend's K1 with TF32
    allowed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(17)
    xs, ys = _rand_ints(rng, 4096, o.P), _rand_ints(rng, 4096, o.P)
    X = FieldElement.from_int(xs, dev, tl.FIELD_F9)
    Y = FieldElement.from_int(ys, dev, tl.FIELD_F9)
    want = (FieldElement.from_int(xs, dev) * FieldElement.from_int(ys, dev)).to_bytes()
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("medium")
        assert torch.equal((X * Y).to_bytes(), want)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


# ---------------------------------------------------------------------------
# The recoder's limb codecs, profiling, checkpoint.load
# ---------------------------------------------------------------------------


def test_recode_limb_codecs_match_native():
    rng = np.random.default_rng(21)
    b = rng.integers(0, 256, (3, 5, 32), dtype=np.uint8)
    limbs = recode.bytes_to_limbs(b)
    assert limbs.dtype == np.int32 and limbs.shape == (3, 5, 22)
    assert np.array_equal(limbs, jnative.bytes_to_limbs(b))
    assert np.array_equal(recode.limbs_to_bytes(limbs), jnative.limbs_to_bytes(limbs))
    assert np.array_equal(recode.limbs_to_bytes(limbs), b)
    assert not hasattr(recode, "available")


def test_profiling_timeit_report_and_trace(tmp_path):
    x = torch.arange(22, dtype=torch.int32).expand(64, 22).contiguous()
    t = profiling.timeit(tl.mul, x, x, tl.FIELD, iters=3, warmup=1)
    assert 0 < t < 10
    rep = profiling.report().splitlines()
    assert rep[0].startswith("kernel") and len(rep) == 7
    assert [ln.split()[0] for ln in rep[1:3]] == ["field_mul", "field_add"]
    assert profiling.OPS_8X32 == (104, 76)
    assert profiling.FIELD_MUL.int_ops == 104 and profiling.FIELD_MUL.bytes_moved == 264
    assert (profiling.FIELD_ADD.int_ops, profiling.FIELD_ADD.bytes_moved) == (0, 264)
    with profiling.trace(str(tmp_path)) as prof:
        tl.mul(x, x, tl.FIELD)
    assert Path(prof.trace_path).parent == tmp_path and Path(prof.trace_path).stat().st_size


def test_checkpoint_load_defaults_to_the_card(tmp_path):
    path = str(tmp_path / "a.ckpt")
    pt = EdwardsPoint.basepoint((3,))
    checkpoint.save(path, pt, 5, {"n": 3})
    config.set_default_device(None)
    try:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                checkpoint.load(path)
        with config.use_device("cpu"):
            got, nxt, meta = checkpoint.load(path)
    finally:
        config.set_default_device("cpu")
    assert (nxt, meta) == (5, {"n": 3}) and got.X.device.type == "cpu"
    for c, want in zip(got._tuple(), pt._tuple()):
        assert torch.equal(tl.canonical_plain(c, tl.FIELD), tl.canonical_plain(want, tl.FIELD))


# ---------------------------------------------------------------------------
# The entry step, its dry run, the examples
# ---------------------------------------------------------------------------


def test_entry_matches_jax_entry():
    fn, (base, bits) = tentry.entry(device="cpu")
    jfn, (jbase, jbits) = jentry.entry()
    assert base.dtype == torch.int32 and bits.dtype == torch.int32
    assert np.array_equal(base.numpy(), jbase) and np.array_equal(bits.numpy(), jbits)
    out = fn(base[:N], bits[:N])
    assert out.dtype == torch.uint8 and out.shape == (N, 32)
    want = np.asarray(jfn(jnp.asarray(jbase[:N]), jnp.asarray(jbits[:N])))
    assert np.array_equal(out.numpy(), want)
    k0 = sum(int(v) << i for i, v in enumerate(jbits[0]))
    assert out[0].numpy().tobytes() == o.ristretto_compress(
        o.scalar_mul(o.BASEPOINT, k0))


def test_dryrun_multichip_two_cpu_ranks(background):
    text = _finished(background, "dryrun")
    assert "dryrun_multichip(2): sharded MSM of 64 points (auto c=8, signed digits) ok" in text
    assert "production pod config (dense bucket kernel + shard_combine, 32 points) ok" in text


@pytest.mark.parametrize("name", ["basic_ops", "msm_demo", "serving"])
def test_example_main_on_cpu(background, name):
    assert f"EXAMPLE {name} OK" in _finished(background, "examples")
