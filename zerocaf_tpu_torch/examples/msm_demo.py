"""Multi-scalar multiplication: Pippenger on one device, then the same sum
through ``msm_sharded`` on a one-rank mesh (examples/msm_demo.py
counterpart).  The JAX example shards over a mesh of devices in one
process; here a rank is a process, and ``zerocaf_tpu_torch.entry.
dryrun_multichip`` is the multi-rank run.

    python -m zerocaf_tpu_torch.examples.msm_demo
"""

from __future__ import annotations

import time

import torch

from zerocaf_tpu_torch import EdwardsPoint, RistrettoPoint, Scalar, config
from zerocaf_tpu_torch import oracle
from zerocaf_tpu_torch.config import MeshConfig
from zerocaf_tpu_torch.parallel import make_mesh, msm, msm_sharded

N = 1024
SEED = 1
C_WIDTH = 8


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(device=None, n: int = N, c: int = C_WIDTH) -> None:
    device = config.resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    k1 = Scalar.random(gen, (n,), device)
    scalars = Scalar.random(gen, (n,), device)
    pts = EdwardsPoint.basepoint((n,), device) * k1

    t0 = time.perf_counter()
    total = msm(pts, scalars, c=c)
    _sync(device)
    print(f"single-device MSM of {n} points: {time.perf_counter() - t0:.2f}s "
          f"(first call)")
    wire = RistrettoPoint(total).compress().cpu().numpy().tobytes()
    print("result:", wire.hex())
    # sum k_i (k1_i B) = (sum k_i k1_i) B
    agg = sum(a * b for a, b in zip(k1.to_ints(), scalars.to_ints())) % oracle.R
    if wire != oracle.ristretto_compress(oracle.scalar_mul(oracle.BASEPOINT, agg)):
        raise AssertionError("MSM differs from the oracle")

    mesh = make_mesh(MeshConfig(n_devices=1), devices=device)
    t0 = time.perf_counter()
    total_s = msm_sharded(pts, scalars, mesh, c=c)
    _sync(device)
    print(f"msm_sharded on a one-rank mesh: {time.perf_counter() - t0:.2f}s "
          f"(the multi-rank run is zerocaf_tpu_torch.entry.dryrun_multichip)")
    same = RistrettoPoint(total_s).compress().cpu().numpy().tobytes() == wire
    print("bit-exact vs single device:", same)
    if not same:
        raise AssertionError("msm_sharded differs from msm")


if __name__ == "__main__":
    main()
