"""PyTorch port: ``k_canonical`` on the card, the limb engine's observation
boundary (tests marked ``cuda``; they skip without a card).

The kernel is held against its plain version bit for bit in every mode
(canonical limbs, bytes, zero, >= a bound, equality) on the edge set of
``canon_cases.py`` at ragged lane counts and on 2^20 random semi-reduced
lanes, modulo p and r.  The limb engine's observers on CUDA tensors launch
it once each, and a served ``Engine.dh`` and ``Engine.msm`` observe through
it alone (no plain carry on a CUDA tensor) and keep the reference's
answers.  The CPU tests of the plain version are in
``test_torch_field_kernels.py``; this file imports no JAX, so it runs on
the card's machine as it is."""

import numpy as np
import pytest
import torch

import canon_cases as cc
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from zerocaf_tpu_torch import Engine
from zerocaf_tpu_torch import oracle as o
from zerocaf_tpu_torch.ops import inv_sqrt as isq
from zerocaf_tpu_torch.ops import limb as tl
from zerocaf_tpu_torch.ops.kernels import field_kernels as fk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _launch_and_compare(x, spec, mode, **kw):
    """One wrapper call on the card: one launch, equal to the plain
    version on the same tensors."""
    before = fk.canonical_tiled.launches
    got = fk.canonical_tiled(x, spec, mode, **kw)
    assert fk.canonical_tiled.launches == before + 1
    assert torch.equal(got, fk.canonical_tiled_ref(x, spec, mode, **kw))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("mode", cc.MODES)
@pytest.mark.parametrize("modulus", ["p", "r"])
def test_kernel_equals_plain_on_the_edge_set(cuda, modulus, mode):
    """The edge set and the slack vectors, then the set repeated to 1, 33
    and 32769 lanes (ragged last blocks), and a view one lane in (not
    16-byte aligned: the word-by-word tile copy)."""
    spec, m, bound = cc.MODULI[modulus]
    rows, vals = cc.cases(m, bound)
    kw = cc.mode_args(spec, m, bound, mode, vals, device=cuda)
    x = torch.tensor(rows, device=cuda)
    got = _launch_and_compare(x, spec, mode, **kw)
    assert got.cpu().tolist() == cc.expected(mode, vals, m, bound)
    for lanes in (1, 33, 32769):
        idx = torch.arange(lanes + 1, device=cuda) % len(vals)
        xs = x[idx]
        other = kw["other"][idx] if mode == "eq" else None
        for cut in (slice(0, lanes), slice(1, None)):     # aligned, one lane in
            args = {"other": other[cut]} if mode == "eq" else kw
            _launch_and_compare(xs[cut], spec, mode, **args)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", cc.MODES)
@pytest.mark.parametrize("modulus", ["p", "r"])
def test_kernel_equals_plain_on_2p20_semi_lanes(cuda, modulus, mode):
    """2^20 random semi-reduced lanes (non-top limbs in [-13, 4109), top
    limb in [-2, 2)); in mode "eq" every other lane's second operand is
    the same value in other limbs (4096 moved from limb 1 into limb 0),
    the rest the next lane's value."""
    spec, m, bound = cc.MODULI[modulus]
    n = 1 << 20
    g = torch.Generator(device=cuda).manual_seed(35 + len(mode))
    x = torch.randint(-13, 4109, (n, 22), generator=g, device=cuda, dtype=torch.int32)
    x[:, 21] = torch.randint(-2, 2, (n,), generator=g, device=cuda, dtype=torch.int32)
    kw = cc.mode_args(spec, m, bound, mode, [], device=cuda) if mode == "geq" else {}
    if mode == "eq":
        same = x.clone()
        same[:, 0] += 4096
        same[:, 1] -= 1
        even = (torch.arange(n, device=cuda) % 2 == 0)[:, None]
        kw = {"other": torch.where(even, same, x.roll(1, 0)).contiguous()}
    got = _launch_and_compare(x, spec, mode, **kw)
    if mode == "eq":
        assert bool(got[::2].all())


@pytest.mark.cuda
def test_observers_launch_once_each(cuda):
    """canonical, to_bytes, eq, is_zero, canonical_geq and
    inv_sqrt.is_positive on CUDA tensors: one launch each, the reads of
    their CPU twins."""
    spec, m, bound = cc.MODULI["p"]
    rows, vals = cc.cases(m, bound)
    other = cc.mode_args(spec, m, bound, "eq", vals)["other"].numpy()
    x, y = torch.tensor(rows, device=cuda), torch.tensor(other, device=cuda)
    xc, yc = x.cpu(), y.cpu()
    pos = tl.spec_limbs(o.POS_RANGE + 1, spec)
    calls = {"canonical": lambda a, b: tl.canonical(a, spec),
             "to_bytes": lambda a, b: tl.to_bytes(a, spec),
             "eq": lambda a, b: tl.eq(a, b, spec),
             "is_zero": lambda a, b: tl.is_zero(a, spec),
             "canonical_geq": lambda a, b: tl.canonical_geq(a, pos, spec),
             "is_positive": lambda a, b: isq.is_positive(a, spec)}
    for name, call in calls.items():
        before = fk.canonical_tiled.launches
        got = call(x, y)
        assert fk.canonical_tiled.launches == before + 1, name
        assert torch.equal(got.cpu(), call(xc, yc)), name
        assert fk.canonical_tiled.launches == before + 1, name


@pytest.mark.cuda
def test_served_calls_observe_through_the_kernel(cuda, monkeypatch):
    """A served Engine.dh and Engine.msm at batch 4096 launch
    canonical_tiled, never run the plain carry (limb.carry_exact) on a
    CUDA tensor, and keep the reference's answers: every lane's ok mask
    (one lane in 64 a non-canonical encoding, s + p), 32 shared secrets,
    and the MSM's aggregate."""
    n = 4096
    rng = np.random.default_rng(36)
    ks = [int(rng.integers(1, 1 << 62)) for _ in range(16)]
    wires = [o.ristretto_compress(o.scalar_mul(o.BASEPOINT, k)) for k in ks]
    pick = rng.integers(0, len(ks), n)
    pts = np.frombuffer(b"".join(wires[j] for j in pick), np.uint8).reshape(n, 32).copy()
    bad = np.arange(n) % 64 == 5
    peer = pts.copy()
    for i in np.flatnonzero(bad):
        s = int.from_bytes(peer[i].tobytes(), "little")
        peer[i] = np.frombuffer((s + o.P).to_bytes(32, "little"), np.uint8)
    sk = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    sk[:, 31] &= 0x0F
    eng = Engine(batch=n, device=cuda)
    eng.dh(sk, peer)                               # builds the kernels
    devices = []
    carry = tl.carry_exact
    monkeypatch.setattr(tl, "carry_exact",
                        lambda x, *a: devices.append(x.device.type) or carry(x, *a))

    before = fk.launch_counts()["canonical_tiled"]
    wire, ok = eng.dh(sk, peer)
    torch.cuda.synchronize()
    dh_launches = fk.launch_counts()["canonical_tiled"] - before
    assert ok.cpu().tolist() == (~bad).tolist()
    wire = wire.cpu().numpy()
    for i in rng.choice(np.flatnonzero(~bad), 32, replace=False):
        k = int.from_bytes(sk[i].tobytes(), "little") * ks[pick[i]] % o.R
        assert wire[i].tobytes() == o.ristretto_compress(o.scalar_mul(o.BASEPOINT, k))

    sc = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    sc[:, 31] &= 0x0F
    before = fk.launch_counts()["canonical_tiled"]
    total, ok = eng.msm(pts, sc)
    torch.cuda.synchronize()
    msm_launches = fk.launch_counts()["canonical_tiled"] - before
    assert bool(ok)
    k = sum(int.from_bytes(sc[i].tobytes(), "little") * ks[pick[i]] for i in range(n)) % o.R
    assert total.cpu().numpy().tobytes() == o.ristretto_compress(o.scalar_mul(o.BASEPOINT, k))
    assert dh_launches > 0 and msm_launches > 0
    assert "cuda" not in devices
