"""Basic usage: batched G * k over a lane of scalars, Ristretto encoding of
every result, and the decode round trip (examples/basic_ops.py
counterpart).

    python -m zerocaf_tpu_torch.examples.basic_ops
"""

from __future__ import annotations

import torch

from zerocaf_tpu_torch import EdwardsPoint, RistrettoPoint, Scalar, config
from zerocaf_tpu_torch import oracle

BATCH = 64
SEED = 0


def main(device=None, batch: int = BATCH) -> None:
    device = config.resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(SEED)

    # a lane of random scalars mod r
    k = Scalar.random(gen, (batch,), device)
    print("scalars:", k)

    # G * k, batched: the oblivious ladder runs once for all lanes (K3)
    P = EdwardsPoint.basepoint((batch,), device) * k
    print("points:", P)

    # Ristretto wire encoding of every result
    wire = RistrettoPoint(P).compress()
    print("first three encodings:")
    for row in wire[:3].cpu().numpy():
        print(" ", bytes(row).hex())

    # round trip, and the first lane against the oracle
    back, ok = RistrettoPoint.decompress(wire)
    if not bool(ok.all()):
        raise AssertionError("a valid encoding was rejected")
    if not bool(back.eq(RistrettoPoint(P)).all()):
        raise AssertionError("round trip changed a point")
    k0 = int(k[0].to_ints())
    want = oracle.ristretto_compress(oracle.scalar_mul(oracle.BASEPOINT, k0))
    if wire[0].cpu().numpy().tobytes() != want:
        raise AssertionError("lane 0 differs from the oracle")
    print(f"all {batch} encodings round-trip OK")


if __name__ == "__main__":
    main()
