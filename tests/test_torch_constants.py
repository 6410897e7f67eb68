"""PyTorch port: constants, oracle access, interop, and the no-jax import."""

import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import zerocaf_tpu.constants as jc
from zerocaf_tpu import oracle as jo
from zerocaf_tpu_torch import constants as tc
from zerocaf_tpu_torch import interop
from zerocaf_tpu_torch import oracle as to

REPO = Path(__file__).resolve().parent.parent


def test_constants_match_jax_package():
    interop.check_constants(jc)


def test_check_constants_detects_a_difference():
    ns = types.SimpleNamespace(**{k: getattr(jc, k) for k in dir(jc)
                                  if not k.startswith("_")})
    bad = np.array(jc.SQRT_M1_LIMBS)
    bad[3] ^= 1
    ns.SQRT_M1_LIMBS = bad
    with pytest.raises(AssertionError, match="SQRT_M1_LIMBS"):
        interop.check_constants(ns)


def test_oracle_is_the_jax_package_file():
    assert to.PATH == Path(jo.__file__).resolve()
    assert (to.P, to.R, to.EDWARDS_D, to.BASEPOINT) == (jo.P, jo.R, jo.EDWARDS_D,
                                                       jo.BASEPOINT)
    assert tc.CHAIN_EXPONENTS == (jc.EXP_INV, jc.EXP_LEGENDRE, jc.EXP_SQRT,
                                  jc.EXP_SQRT_RATIO)


def test_import_leaves_jax_out():
    code = ("import sys, zerocaf_tpu_torch, zerocaf_tpu_torch.interop; "
            "bad = [m for m in ('jax', 'zerocaf_tpu') if m in sys.modules]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True,
                   timeout=120)


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
