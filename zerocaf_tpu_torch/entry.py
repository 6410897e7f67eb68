"""The port's entry points (__graft_entry__.py counterpart).

entry():            one forward step on the flagship path -- batched k B
                    by the oblivious ladder, then Ristretto compression.
dryrun_multichip(): the sharded MSM over n ranks of torch.distributed
                    (gloo), in the scan and the pod configuration, each
                    held against the oracle.

    python -m zerocaf_tpu_torch.entry

runs the forward step and dryrun_multichip(4) on the first CUDA card (four
ranks sharing it).
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch

from . import config
from . import constants as C
from .models import ristretto as _ri
from .ops.kernels import field_kernels as _fk

DRYRUN_POINTS = 1 << 12      # the scan configuration's points
DRYRUN_SEED = 7


def entry(batch: int = 256, device=None):
    """Returns (fn, example_args).  fn(point_coords [batch, 4, 22] int32,
    scalar_bits [batch, 250] int32) computes k P by the oblivious 250-step
    ladder (K3, one launch on the card) and Ristretto-compresses it (K1 and
    K2) -> [batch, 32] uint8.  The arguments are the JAX entry's: the
    basepoint broadcast to the batch and bits from
    ``np.random.default_rng(0)``, on ``device`` (None: the default
    device)."""
    device = config.resolve_device(device)

    def fn(point_coords: torch.Tensor, scalar_bits: torch.Tensor) -> torch.Tensor:
        pt = tuple(point_coords[:, i].contiguous() for i in range(4))
        q = _fk.scalar_mul_windowed_stepped(pt, scalar_bits.contiguous(), 1)
        return _ri._compress(q)

    base = np.broadcast_to(C.BASEPOINT.astype(np.int32), (batch, 4, 22)).copy()
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, size=(batch, 250)).astype(np.int32)
    return fn, (torch.as_tensor(base, device=device),
                torch.as_tensor(bits, device=device))


def dryrun_multichip(n_ranks: int, device=None, n_scan: int = DRYRUN_POINTS,
                     n_pod: int | None = None) -> None:
    """Spawn ``n_ranks`` processes joined in a gloo group (a file
    rendezvous in a temporary directory), each computing on ``device``
    (None: the default device, the first CUDA card), and run the sharded
    MSM twice, as the JAX package's dry run does:

    1. the scan configuration: ``n_scan`` points (2^12), auto c, signed
       digits;
    2. the pod configuration: dense=True, shard_combine=True (K9 once a
       window group and the window-sharded combine, one K8 call a rank) at
       ``n_pod`` points (max(8 n_ranks, 256)).

    Every rank asserts its total against the oracle; rank 0 prints one line
    a configuration.  A rank that fails raises in the caller."""
    import torch.multiprocessing as mp

    dev = str(config.resolve_device(device))
    n_pod = max(8 * n_ranks, 256) if n_pod is None else n_pod
    with tempfile.TemporaryDirectory() as tmpdir:
        mp.spawn(_dryrun_rank, args=(n_ranks, dev, f"{tmpdir}/rendezvous",
                                     n_scan, n_pod),
                 nprocs=n_ranks, join=True)


def _dryrun_rank(rank: int, n_ranks: int, device: str, rendezvous: str,
                 n_scan: int, n_pod: int) -> None:
    """One rank of ``dryrun_multichip`` (a spawned process)."""
    import torch.distributed as dist

    from . import oracle
    from .config import MeshConfig
    from .models.edwards import EdwardsPoint
    from .parallel import batch_sharding, make_mesh, msm_sharded
    from .parallel.msm import auto_c
    from .scalar import Scalar

    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)         # the ranks share the host's cores
    config.set_default_device(device)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            world_size=n_ranks, rank=rank)
    try:
        mesh = make_mesh(MeshConfig(n_devices=n_ranks), devices=device)
        shard = batch_sharding(mesh)

        def run(n, ks, what, **kw):
            """msm_sharded of k_i B over this rank's block, against the
            oracle's (sum k_i) B."""
            pts = EdwardsPoint(*(shard(c) for c in
                                 EdwardsPoint.basepoint((n,), "cpu")._tuple()))
            sc = Scalar(shard(Scalar.from_int(ks, "cpu").limbs))
            total = msm_sharded(pts, sc, mesh, **kw)
            want = oracle.scalar_mul(oracle.BASEPOINT,
                                     int(sum(int(k) for k in ks)) % oracle.R)
            if not oracle.point_eq(tuple(int(v) for v in total.to_ints()), want):
                raise AssertionError(f"rank {rank}: {what} mismatch")

        # 1. scan route
        c = auto_c(n_scan)
        rng = np.random.default_rng(DRYRUN_SEED)
        ks = rng.integers(1, 1 << 62, size=n_scan).astype(object)
        ks[:4] = [1, 2, oracle.R - 1, (1 << 249) + 5]      # edge scalars
        run(n_scan, ks, "sharded MSM", c=c, signed=True)
        if rank == 0:
            print(f"dryrun_multichip({n_ranks}): sharded MSM of {n_scan} points "
                  f"(auto c={c}, signed digits) ok", flush=True)

        # 2. the pod configuration: dense kernels + shard_combine
        ks2 = rng.integers(1, 1 << 62, size=n_pod).astype(object)
        ks2[:2] = [oracle.R - 1, (1 << 249) + 5]
        run(n_pod, ks2, "pod-config dense MSM", dense=True, shard_combine=True)
        if rank == 0:
            print(f"dryrun_multichip({n_ranks}): production pod config "
                  f"(dense bucket kernel + shard_combine, {n_pod} points) ok",
                  flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main() -> None:
    fn, args = entry()
    out = fn(*args)
    if out.is_cuda:
        torch.cuda.synchronize()
    print("entry forward:", tuple(out.shape), out.dtype, out.device)
    dryrun_multichip(4)


if __name__ == "__main__":
    main()
