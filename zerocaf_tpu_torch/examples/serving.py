"""The serving engine: wire bytes in, wire bytes out (examples/serving.py
counterpart).  Batched keygen, ECDH on both sides, hash-to-group, and an
MSM aggregate of a ragged request padded to the engine batch.

    python -m zerocaf_tpu_torch.examples.serving
"""

from __future__ import annotations

import torch

from zerocaf_tpu_torch import oracle
from zerocaf_tpu_torch.serving import Engine, pad_msm

BATCH = 64
SEED = 0


def main(device=None, batch: int = BATCH) -> None:
    gen = torch.Generator(device="cpu").manual_seed(SEED)

    def uniform(*shape):
        return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)

    eng = Engine(batch=batch, device=device)

    # keygen: uniform seeds -> (scalar bytes, Ristretto public keys)
    sk_a, pk_a = eng.keygen(uniform(batch, 64))
    sk_b, pk_b = eng.keygen(uniform(batch, 64))
    print(f"keygen: {batch} keypairs; pk[0] = "
          f"{pk_a[0].cpu().numpy().tobytes().hex()[:32]}...")

    # ECDH: both sides derive the same shared wire bytes
    shared_a, ok_a = eng.dh(sk_a, pk_b)
    shared_b, ok_b = eng.dh(sk_b, pk_a)
    if not (bool(ok_a.all()) and bool(ok_b.all())):
        raise AssertionError("dh rejected a valid key")
    if not torch.equal(shared_a, shared_b):
        raise AssertionError("the two sides' secrets differ")
    print(f"dh: {batch} shared secrets agree on both sides")

    # hash-to-group (Elligator twice, from_uniform_bytes)
    uni = uniform(batch, 64)
    pts = eng.hash_to_group(uni)
    want = oracle.ristretto_compress(oracle.from_uniform_bytes(uni[0].numpy().tobytes()))
    if pts[0].cpu().numpy().tobytes() != want:
        raise AssertionError("hash_to_group differs from the oracle")
    print(f"hash_to_group: {batch} points; first = "
          f"{pts[0].cpu().numpy().tobytes().hex()[:32]}...")

    # MSM over a ragged request, padded to the engine batch
    n_req = batch - 3
    sc = uniform(n_req, 32).numpy()
    sc[:, 31] &= 0x03                                 # canonical scalars
    pw, sw, n_valid = pad_msm(pk_a.cpu().numpy()[:n_req], sc, batch)
    agg, ok = eng.msm(pw, sw, c=4)
    if not bool(ok):
        raise AssertionError("msm rejected valid points")
    ska = sk_a.cpu().numpy()
    want = sum(int.from_bytes(ska[i].tobytes(), "little")
               * int.from_bytes(sc[i].tobytes(), "little")
               for i in range(n_req)) % oracle.R
    if agg.cpu().numpy().tobytes() != oracle.ristretto_compress(
            oracle.scalar_mul(oracle.BASEPOINT, want)):
        raise AssertionError("msm differs from the oracle")
    print(f"msm: aggregated {n_valid} (point, scalar) pairs -> "
          f"{agg.cpu().numpy().tobytes().hex()[:32]}...")
    print("served pipelines:", ", ".join(eng.compiled()))


if __name__ == "__main__":
    main()
