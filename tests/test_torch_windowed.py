"""PyTorch port: ``EdwardsPoint.mul_windowed`` at every width, wide
``Scalar.windows``, and the JAX package's keyword arguments that have no
effect on the card.

Width 4 runs the signed windows (K4); every other width the unsigned
``_scalar_mul_windowed``, as in the JAX package.  Each result is held
against the ladder ``B * s`` (K3's plain version) and the oracle, by
projective equality, and at widths 2 and 3 against the JAX package's
``mul_windowed`` (its XLA route on the CPU) too: that route unrolls its
2^width-entry table build into one XLA program, whose CPU compile takes
some 35 s at width 5, 110 s at width 6 and 440 s at width 7.  The
scalars include r - 1 and the values just around 2^249, whose top windows
carry at widths 2 and 5."""

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from zerocaf_tpu import oracle as o
from zerocaf_tpu.models import edwards as jed
from zerocaf_tpu.scalar import Scalar as JScalar
from zerocaf_tpu_torch import EdwardsPoint, Engine, Scalar
from zerocaf_tpu_torch.models import edwards as ted

SCALARS = [o.R - 1, 2**249 + 5, 2**249 - 1, 12345]
JAX_WIDTHS = (2, 3)           # the widths whose JAX compile is cheap


def _ints(coords):
    """4 coordinate arrays [n, 22] -> oracle points (limbs may be signed)."""
    cols = [np.asarray(c).reshape(-1, 22) for c in coords]
    return [tuple(o.limbs_to_int(c[i]) % o.P for c in cols)
            for i in range(cols[0].shape[0])]


@pytest.fixture(scope="module")
def ladder():
    """B * s by the port's ladder (K3's plain version), one lane a scalar."""
    s = Scalar.from_int(SCALARS)
    return _ints(t.numpy() for t in (EdwardsPoint.basepoint((len(SCALARS),)) * s)._tuple())


@pytest.mark.parametrize("width", [2, 3, 5, 6, 7])
def test_mul_windowed_matches_ladder_jax_and_oracle(ladder, width):
    n = len(SCALARS)
    got = EdwardsPoint.basepoint((n,)).mul_windowed(Scalar.from_int(SCALARS), width)
    got = _ints(t.numpy() for t in got._tuple())
    for i, k in enumerate(SCALARS):
        assert o.point_eq(got[i], o.scalar_mul(o.BASEPOINT, k)), (width, k)
        assert o.point_eq(got[i], ladder[i]), (width, k)
    if width in JAX_WIDTHS:
        jgot = jed.EdwardsPoint.basepoint((n,)).mul_windowed(
            JScalar.from_int(SCALARS), width)
        assert all(o.point_eq(j, g) for j, g in zip(_ints(jgot._tuple()), got))


@pytest.mark.parametrize("width", [20, 25, 31])
def test_wide_windows_match_jax(width):
    """Widths past 19 take the bit path, as in the JAX package; the windows
    are int32."""
    vals = SCALARS + [0, 1]
    nwin = -(-250 // width)
    got = Scalar.from_int(vals).windows(width, nwin)
    want = np.asarray(JScalar.from_int(vals).windows(width, nwin))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)
    for v, row in zip(vals, got.numpy()):
        assert sum(int(d) << (width * i) for i, d in enumerate(row)) == v


def test_jax_keyword_arguments_are_accepted(monkeypatch, tmp_path):
    """Engine(batch, donate=), mul_windowed(use_fused=) and
    basepoint_mul(use_fused=) take the JAX package's keyword arguments,
    which pick TPU compilation there and change nothing here."""
    monkeypatch.setattr(ted, "CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(ted, "COMB_WIDTH_SIGNED", 8)
    for donate in (True, False):
        eng = Engine(8, donate=donate, device="cpu")
        assert eng.batch == 8 and eng.device == torch.device("cpu")
    s = Scalar.from_int(SCALARS[2:])
    want = [o.scalar_mul(o.BASEPOINT, k) for k in SCALARS[2:]]
    B = EdwardsPoint.basepoint((2,))
    for use_fused in (True, False):
        for p in (B.mul_windowed(s, 4, use_fused=use_fused),
                  EdwardsPoint.basepoint_mul(s, use_fused=use_fused)):
            got = _ints(t.numpy() for t in p._tuple())
            assert all(o.point_eq(g, w) for g, w in zip(got, want))
