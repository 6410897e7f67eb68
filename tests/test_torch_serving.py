"""PyTorch port: the serving Engine (keygen, dh, hash_to_group) byte-equal
to the JAX package and to the oracle, and the whole ECDH flow."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from zerocaf_tpu import Scalar as JScalar
from zerocaf_tpu import oracle as o
from zerocaf_tpu.models import edwards as jed
from zerocaf_tpu.models import ristretto as jri
from zerocaf_tpu.serving import Engine as JaxEngine
from zerocaf_tpu_torch import Engine, RistrettoPoint, Scalar
from zerocaf_tpu_torch.models import edwards as ted
from zerocaf_tpu_torch.serving import pad_batch

BATCH = 8


def _sk(seeds):
    return np.stack([np.frombuffer(
        (int.from_bytes(s.tobytes(), "little") % o.R).to_bytes(32, "little"),
        np.uint8) for s in seeds])


@pytest.fixture(scope="module")
def flow():
    rng = np.random.default_rng(51)
    seeds_a = rng.integers(0, 256, (BATCH, 64), dtype=np.uint8)
    seeds_b = rng.integers(0, 256, (BATCH, 64), dtype=np.uint8)
    ka = [int.from_bytes(s.tobytes(), "little") % o.R for s in seeds_a]
    kb = [int.from_bytes(s.tobytes(), "little") % o.R for s in seeds_b]
    pk_b = np.stack([np.frombuffer(o.ristretto_compress(o.scalar_mul(o.BASEPOINT, k)),
                                   np.uint8) for k in kb])
    peer = pk_b.copy()
    peer[1] = 0xFF                                   # non-canonical encoding
    uniform = rng.integers(0, 256, (BATCH, 64), dtype=np.uint8)
    return dict(seeds_a=seeds_a, seeds_b=seeds_b, ka=ka, kb=kb, sk_a=_sk(seeds_a),
                sk_b=_sk(seeds_b), pk_b=pk_b, peer=peer, uniform=uniform)


def test_keygen_matches_jax_composition_and_oracle(monkeypatch):
    """Engine.keygen at comb width 8 (the bytes do not depend on the width)
    against the JAX package's keygen composition at width 8 and the
    oracle.  Lanes 0-3 reduce to k = 2^250 - r (a doubling in the signed
    comb's last addition), 0, 1 and r - 1: the bytes of k, then 32 zero
    bytes."""
    monkeypatch.setattr(ted, "COMB_WIDTH_SIGNED", 8)
    n = 16
    seeds = np.random.default_rng(52).integers(0, 256, (n, 64), dtype=np.uint8)
    for i, k in enumerate([2**250 - o.R, 0, 1, o.R - 1]):
        seeds[i] = np.frombuffer(k.to_bytes(32, "little") + bytes(32), np.uint8)
    sk, pk = Engine(batch=n, device="cpu").keygen(torch.tensor(seeds))
    js = JScalar.from_bytes_wide(jnp.asarray(seeds))
    jpk = jri._compress(jed._fixed_base_mul_signed(js.windows(8, 32), 8))
    assert np.array_equal(sk.numpy(), np.asarray(js.to_bytes()))
    assert np.array_equal(pk.numpy(), np.asarray(jpk))
    for i in range(n):
        k = int.from_bytes(seeds[i].tobytes(), "little") % o.R
        assert sk[i].numpy().tobytes() == k.to_bytes(32, "little")
        assert pk[i].numpy().tobytes() == o.ristretto_compress(
            o.scalar_mul(o.BASEPOINT, k))


def test_dh_matches_jax_engine_and_oracle(flow):
    wire, ok = Engine(batch=BATCH, device="cpu").dh(torch.tensor(flow["sk_a"]),
                                      torch.tensor(flow["peer"]))
    jwire, jok = JaxEngine(batch=BATCH, donate=False).dh(
        jnp.asarray(flow["sk_a"]), jnp.asarray(flow["peer"]))
    ok, wire = ok.numpy(), wire.numpy()
    assert np.array_equal(ok, np.asarray(jok))
    assert not ok[1] and ok[[0] + list(range(2, BATCH))].all()
    # invalid lanes hold garbage in both packages; valid lanes are bytes
    assert np.array_equal(wire[ok], np.asarray(jwire)[ok])
    for i in np.flatnonzero(ok):
        assert wire[i].tobytes() == o.ristretto_compress(
            o.scalar_mul(o.BASEPOINT, flow["ka"][i] * flow["kb"][i] % o.R))


def test_hash_to_group_matches_jax_engine_and_oracle(flow):
    got = Engine(batch=BATCH, device="cpu").hash_to_group(
        torch.tensor(flow["uniform"])).numpy()
    want = np.asarray(JaxEngine(batch=BATCH, donate=False).hash_to_group(
        jnp.asarray(flow["uniform"])))
    assert np.array_equal(got, want)
    for i in range(BATCH):
        assert got[i].tobytes() == o.ristretto_compress(
            o.from_uniform_bytes(flow["uniform"][i].tobytes()))


def test_ecdh_flow(flow):
    """Random scalars -> public keys by the ladder -> wire -> dh both ways:
    the two sides' shared secrets agree, and equal the oracle."""
    sa = Scalar.from_bytes_wide(torch.tensor(flow["seeds_a"]))
    sb = Scalar.from_bytes_wide(torch.tensor(flow["seeds_b"]))
    assert np.array_equal(sa.to_bytes().numpy(), flow["sk_a"])
    pk_a = (RistrettoPoint.basepoint((BATCH,)) * sa).compress()
    pk_b = (RistrettoPoint.basepoint((BATCH,)) * sb).compress()
    assert np.array_equal(pk_b.numpy(), flow["pk_b"])
    eng = Engine(batch=BATCH, device="cpu")
    s_ab, ok_ab = eng.dh(sa.to_bytes(), pk_b)
    s_ba, ok_ba = eng.dh(sb.to_bytes(), pk_a)
    assert ok_ab.all() and ok_ba.all()
    assert torch.equal(s_ab, s_ba)
    i = 3
    assert s_ab[i].numpy().tobytes() == o.ristretto_compress(
        o.scalar_mul(o.BASEPOINT, flow["ka"][i] * flow["kb"][i] % o.R))


def test_scalar_from_bytes_mask_and_random():
    b = np.zeros((3, 32), np.uint8)
    b[1] = np.frombuffer(o.R.to_bytes(32, "little"), np.uint8)   # == r
    b[2] = np.frombuffer((o.R - 1).to_bytes(32, "little"), np.uint8)
    s, ok = Scalar.from_bytes(torch.tensor(b))
    assert ok.tolist() == [True, False, True]
    assert list(s.to_ints()) == [0, 0, o.R - 1]
    g = torch.Generator().manual_seed(5)
    r = Scalar.random(g, (4,))
    assert r.shape == (4,) and all(0 <= v < o.R for v in r.to_ints())


def test_pad_batch_and_pinned_batch():
    arr = np.ones((3, 32), np.uint8)
    padded, n = pad_batch(arr, BATCH)
    assert n == 3 and padded.shape == (BATCH, 32) and not padded[3:].any()
    with pytest.raises(ValueError):
        pad_batch(np.ones((BATCH + 1, 32), np.uint8), BATCH)
    with pytest.raises(ValueError, match="pad_batch"):
        Engine(batch=BATCH, device="cpu").hash_to_group(
            torch.zeros((3, 64), dtype=torch.uint8))


# --- Engine.pipeline and Engine.compiled (tests/test_serving.py's contract) ----

def test_pipeline_overlap_correctness():
    """Results come back in submission order, byte-equal to sequential
    calls, with never more than ``depth`` calls in flight and None while
    the pipeline fills."""
    rng = np.random.default_rng(53)
    eng = Engine(batch=2, device="cpu")
    inputs = [rng.integers(0, 256, (2, 64), dtype=np.uint8) for _ in range(5)]
    seq = [eng.hash_to_group(b).numpy() for b in inputs]
    pipe = eng.pipeline("hash_to_group", depth=2)
    got = []
    for i, b in enumerate(inputs):
        done = pipe.submit(b)
        assert len(pipe) <= 2
        assert (done is None) == (i < 2)
        if done is not None:
            got.append(done)
    got.extend(pipe.drain())
    assert len(pipe) == 0 and len(got) == 5
    for a, b in zip(got, seq):
        assert isinstance(a, np.ndarray) and np.array_equal(a, b)


def test_pipeline_map_and_validation(monkeypatch):
    monkeypatch.setattr(ted, "COMB_WIDTH_SIGNED", 8)
    rng = np.random.default_rng(54)
    eng = Engine(batch=2, device="cpu")
    with pytest.raises(ValueError):
        eng.pipeline("keygen", depth=0)
    pipe = eng.pipeline("keygen", depth=2)
    with pytest.raises(RuntimeError):
        pipe.collect()                                      # nothing submitted
    ins = [rng.integers(0, 256, (2, 64), dtype=np.uint8) for _ in range(3)]
    seq = [tuple(x.numpy() for x in eng.keygen(b)) for b in ins]
    outs = list(pipe.map((b,) for b in ins))
    assert len(outs) == 3
    for (sk_a, pk_a), (sk_b, pk_b) in zip(outs, seq):
        assert np.array_equal(sk_a, sk_b) and np.array_equal(pk_a, pk_b)


def test_compiled_names_the_served_calls(flow):
    """Engine.compiled() lists, sorted, the JAX package's names of the calls
    served; a second MSM call on the same route adds none."""
    n = 4
    eng = Engine(batch=n, device="cpu")
    assert eng.compiled() == []
    eng.hash_to_group(torch.tensor(flow["uniform"][:n]))
    sc = np.random.default_rng(55).integers(0, 256, (n, 32), dtype=np.uint8)
    sc[:, 31] &= 0x03
    pk = flow["pk_b"][:n]
    wire, ok = eng.msm(pk, sc, c=4, dense=False)
    assert bool(ok)
    names = set(eng.compiled())
    assert names == {"hash_to_group", "msm_decode_c4", "msm_encode_c4"}
    wire2, _ = eng.msm(pk.copy(), sc.copy(), c=4, dense=False)
    assert set(eng.compiled()) == names and torch.equal(wire, wire2)
    wire3, _ = eng.msm(pk, sc, c=4)                          # the dense route
    assert eng.compiled() == sorted(names | {"msm_dense_c4"})
    assert torch.equal(wire, wire3)
    acc = o.IDENTITY
    for i in range(n):
        s_i = int.from_bytes(sc[i].tobytes(), "little") % o.R
        acc = o.point_add(acc, o.scalar_mul(o.BASEPOINT, flow["kb"][i] * s_i % o.R))
    assert wire.numpy().tobytes() == o.ristretto_compress(acc)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2])
def test_pipeline_on_the_card_equals_sequential_calls(cuda, flow, depth):
    """On a CUDA engine the pipeline runs on its own stream from pinned
    buffers and returns the sequential calls' bytes, in order, for host
    arrays and for tensors already on the card."""
    n = 256
    rng = np.random.default_rng(56)
    eng = Engine(batch=n, device=cuda)
    sks = [rng.integers(0, 256, (n, 32), dtype=np.uint8) for _ in range(4)]
    seeds = [rng.integers(0, 256, (n, 64), dtype=np.uint8) for _ in range(4)]
    peer = np.tile(flow["pk_b"], (n // BATCH, 1))
    seq_dh = [tuple(x.cpu().numpy() for x in eng.dh(s, peer)) for s in sks]
    seq_kg = [tuple(x.cpu().numpy() for x in eng.keygen(s)) for s in seeds]
    pipe = eng.pipeline("dh", depth)
    assert pipe._stream is not None and pipe._stream != torch.cuda.current_stream(cuda)
    got = list(pipe.map((s, torch.as_tensor(peer).to(cuda)) for s in sks))
    kg = list(eng.pipeline("keygen", depth).map((s,) for s in seeds))
    for (a, b), (c, d) in zip(got + kg, seq_dh + seq_kg):
        assert np.array_equal(a, c) and np.array_equal(b, d)
