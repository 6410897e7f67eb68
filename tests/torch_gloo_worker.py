"""One rank of the PyTorch port's sharded-MSM tests on the CPU
(tests/test_torch_sharding.py starts it; it is not a test module).

    python tests/torch_gloo_worker.py RANK WORLD PORT SPEC.json OUT.json

Joins a gloo group of WORLD ranks at localhost:PORT (no group at WORLD 1),
takes this rank's block of the global points and scalars in SPEC (limbs
as nested lists), runs ``msm_sharded`` for each configuration in SPEC, and
writes the canonical encodings (hex) with the results of a few
collectives and error checks to OUT; then the same on every sub-mesh of
ranks 0..d-1 (d below WORLD, dividing N), which ranks d and up are not
part of.  Runs on one CPU thread, so that
several ranks share a small machine, with the port's default device set to
the CPU.
"""

from __future__ import annotations

import json
import sys

import torch


def main(rank: int, world: int, port: int, spec_path: str, out_path: str) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from zerocaf_tpu_torch import EdwardsPoint, Scalar, config
    from zerocaf_tpu_torch.config import MeshConfig
    from zerocaf_tpu_torch.models import ristretto as ri
    from zerocaf_tpu_torch.parallel import (Communicator, batch_sharding,
                                            initialize_distributed, make_mesh,
                                            msm_sharded)

    config.set_default_device("cpu")
    with open(spec_path) as f:
        spec = json.load(f)
    initialize_distributed(f"localhost:{port}", world, rank, backend="gloo")
    mesh = make_mesh(MeshConfig(n_devices=world), devices="cpu")
    shard = batch_sharding(mesh)
    coords = torch.tensor(spec["points"], dtype=torch.int32)     # [N, 4, 22]
    pts = EdwardsPoint(*(shard(coords[:, j]) for j in range(4)))
    sc = Scalar(shard(torch.tensor(spec["scalars"], dtype=torch.int32)))

    out = {"msm": {}, "raised": {}}
    for name, kw in spec["configs"].items():
        total = msm_sharded(pts, sc, mesh, **kw)
        out["msm"][name] = ri._compress(total._tuple()).numpy().tobytes().hex()

    if world > 1:                     # every rank raises on unequal blocks
        ragged = 1 if rank == 0 else 0
        try:
            msm_sharded(pts[ragged:], sc[ragged:], mesh, c=4)
        except ValueError as e:
            out["raised"]["ragged"] = str(e)

    comm = Communicator(mesh)
    x = torch.arange(3, dtype=torch.int64) + 10 * rank
    out["psum"] = comm.psum(x).tolist()
    out["all_gather"] = comm.all_gather(x).tolist()
    out["all_gather_tiled"] = comm.all_gather(x, tiled=True).tolist()
    ring = [(r, (r + 1) % world) for r in range(world)]
    out["ppermute"] = comm.ppermute(x, ring).tolist()

    # Sub-meshes of ranks 0..d-1 (every rank calls make_mesh; the others
    # get None): an MSM of the same points over d blocks, and a ring.
    out["submesh"] = {}
    for d in range(1, world):
        if len(coords) % d:
            continue
        sub = make_mesh(MeshConfig(n_devices=d), devices="cpu")
        if sub is None:
            out["submesh"][d] = None
            continue
        sub_shard = batch_sharding(sub)
        total = msm_sharded(EdwardsPoint(*(sub_shard(coords[:, j]) for j in range(4))),
                            Scalar(sub_shard(torch.tensor(spec["scalars"],
                                                          dtype=torch.int32))),
                            sub, **spec["configs"][spec["submesh_config"]])
        sub_ring = [(r, (r + 1) % d) for r in range(d)]
        out["submesh"][d] = {
            "size": sub.size, "rank": sub.rank, "grouped": sub.group is not None,
            "msm": ri._compress(total._tuple()).numpy().tobytes().hex(),
            "ppermute": Communicator(sub).ppermute(x, sub_ring).tolist()}
    if mesh.group is not None:
        dist.barrier()
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
