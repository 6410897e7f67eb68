"""PyTorch port: constants, oracle access, interop, and the no-jax import."""

import os
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse)
import zerocaf_tpu.constants as jc
from zerocaf_tpu import oracle as jo
from zerocaf_tpu_torch import constants as tc
from zerocaf_tpu_torch import interop
from zerocaf_tpu_torch import oracle as to

REPO = Path(__file__).resolve().parent.parent


def test_constants_match_jax_package():
    interop.check_constants(jc)


def test_f9_fold_constants_match_jax_package():
    """The f32x29 fold-constant function gives the JAX package's limbs (its
    arrays are held equal by ``check_constants``)."""
    for c in (tc.FOLD_C_P, tc.FOLD_C_R, tc.DELTA_R, 1, (1 << 135) - 1):
        assert np.array_equal(tc.fold_limbs_f9(c), jc.fold_limbs_f9(c))
    assert tc.fold_limbs_f9(1).dtype == np.int32


def test_check_constants_detects_a_difference():
    ns = types.SimpleNamespace(**{k: getattr(jc, k) for k in dir(jc)
                                  if not k.startswith("_")})
    bad = np.array(jc.SQRT_M1_LIMBS)
    bad[3] ^= 1
    ns.SQRT_M1_LIMBS = bad
    with pytest.raises(AssertionError, match="SQRT_M1_LIMBS"):
        interop.check_constants(ns)


def test_oracle_is_the_jax_package_file():
    """The port keeps its own copy of the oracle; the copy must compute what
    the JAX package's file computes."""
    assert not hasattr(to, "PATH")
    assert (to.P, to.R, to.EDWARDS_D, to.BASEPOINT) == (jo.P, jo.R, jo.EDWARDS_D,
                                                       jo.BASEPOINT)
    for name in ("INV_SQRT_A", "INVERSE_MOD_TWO", "MINUS_ONE_HALF",
                 "SCALAR_INVERSE_MOD_TWO", "MONT_A", "MONT_B", "FOUR_COSET_GROUP"):
        assert getattr(to, name) == getattr(jo, name), name
    assert tc.CHAIN_EXPONENTS == (jc.EXP_INV, jc.EXP_LEGENDRE, jc.EXP_SQRT,
                                  jc.EXP_SQRT_RATIO)
    rng = np.random.default_rng(7)
    for _ in range(3):
        k1, k2 = (int.from_bytes(rng.bytes(32), "little") % jo.R for _ in range(2))
        p, q = to.scalar_mul(to.BASEPOINT, k1), to.scalar_mul(to.BASEPOINT, k2)
        assert p == jo.scalar_mul(jo.BASEPOINT, k1)
        assert to.point_add(p, q) == jo.point_add(p, q)
        assert to.ristretto_compress(p) == jo.ristretto_compress(p)
        assert to.point_to_affine(p) == jo.point_to_affine(p)
        assert to.mul_by_pow_2(p, 14) == jo.mul_by_pow_2(p, 14)
        pt = to.point_add(p, to.FOUR_COSET_GROUP[1])
        for q in (p, pt):
            assert to.edwards_compress(q) == jo.edwards_compress(q)
            assert to.edwards_decompress(to.edwards_compress(q)) == \
                jo.edwards_decompress(jo.edwards_compress(q))
            assert to.point_is_valid(q) == jo.point_is_valid(q)
            assert to.ristretto_is_valid(q) == jo.ristretto_is_valid(q)
            assert to.coset4(q) == jo.coset4(q)
            assert to.edwards_to_montgomery_u(q) == jo.edwards_to_montgomery_u(q)
        u = to.edwards_to_montgomery_u(p)
        assert to.montgomery_u_to_edwards_y(u) == jo.montgomery_u_to_edwards_y(u)
    raw = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
    assert to.edwards_decompress(raw) == jo.edwards_decompress(raw)
    _same_scalar_and_helper_functions(rng)


def _same_scalar_and_helper_functions(rng):
    """The oracle's scalar arithmetic, codecs, recodings and point helpers
    give the same answers, and raise alike, in both files."""
    a, b, k = (int.from_bytes(rng.bytes(32), "little") % jo.R for _ in range(3))
    x = int.from_bytes(rng.bytes(32), "little") % jo.P
    for name in ("sadd", "ssub", "smul"):
        assert getattr(to, name)(a, b) == getattr(jo, name)(a, b), name
    for name in ("ssquare", "sneg", "shalf", "sinv", "scalar_to_bytes",
                 "scalar_bits", "compute_naf"):
        assert getattr(to, name)(a) == getattr(jo, name)(a), name
    assert to.spow(a, b) == jo.spow(a, b)
    assert to.fpow(x, a) == jo.fpow(x, a) and to.fhalf(x) == jo.fhalf(x)
    assert to.int_to_limbs52(x) == jo.int_to_limbs52(x)
    assert to.scalar_bits(k, 250) == jo.scalar_bits(k, 250)
    for width in (2, 5, 8):
        assert to.compute_window_naf(k, width) == jo.compute_window_naf(k, width)
    wide = bytes(rng.integers(0, 256, 64, dtype=np.uint8))
    assert to.scalar_from_bytes_wide(wide) == jo.scalar_from_bytes_wide(wide)
    assert to.fe_from_bytes_raw(wide[:32]) == jo.fe_from_bytes_raw(wide[:32])
    enc = to.scalar_to_bytes(k)
    assert to.scalar_from_bytes(enc) == jo.scalar_from_bytes(enc) == k
    for mod in (to, jo):
        with pytest.raises(ValueError):
            mod.scalar_from_bytes((jo.R + 1).to_bytes(32, "little"))
        with pytest.raises(ZeroDivisionError):
            mod.sinv(0)
        with pytest.raises(ValueError):
            mod.compute_naf(1 << 255)
    p = to.scalar_mul(to.BASEPOINT, a)
    q = to.scalar_mul(to.BASEPOINT, b)
    assert to.ltr_bin_mul(p, k) == jo.ltr_bin_mul(p, k)
    assert to.mul_by_cofactor(p) == jo.mul_by_cofactor(p)
    assert to.point_sub(p, q) == jo.point_sub(p, q)
    xy = to.point_to_affine(p)
    assert to.point_from_affine(xy) == jo.point_from_affine(xy)
    coset = to.point_add(p, to.FOUR_COSET_GROUP[2])
    for r in (q, coset):
        assert to.ristretto_eq(p, r) == jo.ristretto_eq(p, r)
    assert to.ristretto_eq(p, coset) and not to.ristretto_eq(p, q)


def test_import_leaves_jax_out():
    code = ("import sys, zerocaf_tpu_torch, zerocaf_tpu_torch.interop, "
            "zerocaf_tpu_torch.oracle, zerocaf_tpu_torch.parallel.msm, "
            "zerocaf_tpu_torch.parallel.mesh, zerocaf_tpu_torch.parallel.comm, "
            "zerocaf_tpu_torch.parallel.checkpoint, "
            "zerocaf_tpu_torch.serving, zerocaf_tpu_torch.models.edwards, "
            "zerocaf_tpu_torch.models.montgomery, zerocaf_tpu_torch.traits, "
            "zerocaf_tpu_torch.recode, zerocaf_tpu_torch.entry, "
            "zerocaf_tpu_torch.utils.profiling, "
            "zerocaf_tpu_torch.examples.basic_ops, "
            "zerocaf_tpu_torch.examples.msm_demo, "
            "zerocaf_tpu_torch.examples.serving, "
            "zerocaf_tpu_torch.tools.pod_msm, "
            "zerocaf_tpu_torch.tools.dist_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'zerocaf_tpu')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True,
                   timeout=120)


def test_port_opens_no_file_of_the_jax_package():
    """No source of the port, and not chip_smoke.py, builds a path into
    zerocaf_tpu/, loads a module by file path, or imports jax or the JAX
    package."""
    files = sorted((REPO / "zerocaf_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    pattern = re.compile(r"""/\s*["']zerocaf_tpu["']|spec_from_file_location"""
                         r"""|open\([^)]*zerocaf_tpu/"""
                         r"""|^\s*(from|import)\s+(zerocaf_tpu|jax)\b""")
    hits = [f"{f.relative_to(REPO)}:{i}: {line.strip()}"
            for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pattern.search(line)]
    assert not hits, hits


def test_limb_interop_roundtrip():
    rng = np.random.default_rng(3)
    arr = rng.integers(-20, 4200, (5, 22)).astype(np.int32)
    t = interop.limbs_from_numpy(arr)
    assert t.dtype == torch.int32 and np.array_equal(interop.limbs_to_numpy(t), arr)
    with pytest.raises(ValueError):
        interop.limbs_from_numpy(arr.astype(np.int64))


@pytest.mark.parametrize("form", ["tuple", "stacked"])
def test_point_interop(form):
    pts = np.stack([jc.BASEPOINT, jc.IDENTITY]).astype(np.int32)   # [2, 4, 22]
    src = tuple(pts[:, i] for i in range(4)) if form == "tuple" else pts
    back = interop.point_to_numpy(interop.point_from_numpy(src))
    for i in range(4):
        assert np.array_equal(back[i], pts[:, i])
