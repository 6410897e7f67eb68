"""Pod MSM harness (tools/pod_msm.py counterpart): from multi-process
start-up to the scaling-efficiency table of the sharded MSM, with the
result checked bit for bit across mesh sizes.

One rank a card, on one host (torchrun sets the rendezvous):

    POD_AUTO_INIT=1 torchrun --nproc-per-node <cards> \\
        -m zerocaf_tpu_torch.tools.pod_msm --log2n 20 --dense --shard-combine

Across hosts, on every host, one process a card:

    python -m zerocaf_tpu_torch.tools.pod_msm --log2n 20 \\
        --coordinator <host0>:<port> --num-processes <P> --process-id <i>

On the CPU (gloo ranks, the plain versions of the kernels; small sizes):

    python -m zerocaf_tpu_torch.tools.pod_msm --cpu --log2n 6 \\
        --coordinator localhost:<port> --num-processes 2 --process-id <i>

With neither the three flags nor POD_AUTO_INIT it runs one rank with no
process group.  Each rank computes on ``cuda:<local rank mod visible
cards>``, or on the CPU under --cpu; there is no fallback to the CPU.  The
backend is --backend, by default nccl, or gloo under --cpu (NCCL refuses
two ranks on one card, so ranks that share a card take gloo).  Ranks that
share a card or a host show correctness, not interconnect scaling: the
scaling lines then say so.

Flow: every rank builds the same inputs (``make_inputs``), then for each
mesh size d (1, 2, 4, ... up to the world size, dividing n; only the world
when the ranks span several hosts) ranks 0..d-1 take their blocks
(``batch_sharding``) and run ``msm_sharded``: one warm call, whose
Ristretto encoding must equal the first size's, then --iters timed calls,
each started after a barrier of the mesh and ended by a synchronise of the
card; the others wait at a barrier of the world.  Rank 0 prints JSON lines
with the JAX tool's keys: the run's shape, each size's median wall time,
each size's scaling efficiency t_1 / (d t_d), and the encoding (printed
also when there is one size); then one line a rank with its kernel launches
and, on a card, its peak memory.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import time

import torch
import torch.distributed as dist

from .. import config
from ..config import MeshConfig
from ..models.edwards import EdwardsPoint
from ..models.ristretto import RistrettoPoint
from ..ops.kernels import field_kernels as _fk
from ..ops.kernels import msm_kernels as _mk
from ..parallel import batch_sharding, initialize_distributed, make_mesh, msm_sharded
from ..parallel.msm import auto_c, auto_c_dense
from ..scalar import Scalar

MESH_SIZES = (1, 2, 4, 8, 16, 32, 64, 128, 256)
SEED = 0
SHARED = "ranks share a card or the host: not interconnect scaling"


def input_scalars(n: int, seed: int, device) -> tuple[Scalar, Scalar]:
    """(k, s): the points' discrete logs and the MSM's scalars, n uniform
    scalars each, drawn from CPU generators seeded 2 seed and 2 seed + 1
    (the JAX tool's key split in two), so that every rank and every device
    gets the same values."""
    g1 = torch.Generator().manual_seed(2 * seed)
    g2 = torch.Generator().manual_seed(2 * seed + 1)
    return Scalar.random(g1, (n,), device), Scalar.random(g2, (n,), device)


def make_inputs(n: int, seed: int, device) -> tuple[EdwardsPoint, Scalar]:
    """The harness's n points k_i B (the fixed-base comb, K6 on a card)
    and scalars s_i on ``device``; their MSM is (sum k_i s_i mod r) B."""
    k, s = input_scalars(n, seed, device)
    return EdwardsPoint.basepoint_mul(k), s


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python -m zerocaf_tpu_torch.tools.pod_msm")
    ap.add_argument("--log2n", type=int, default=20)
    ap.add_argument("--c", type=int, default=0, help="window bits (0 = auto)")
    ap.add_argument("--cpu", action="store_true",
                    help="ranks on the CPU (the kernels' plain versions)")
    ap.add_argument("--dense", action="store_true",
                    help="dense bucket kernels on each rank")
    ap.add_argument("--shard-combine", action="store_true",
                    help="window-sharded combine (one K8 call a rank)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (several processes)")
    ap.add_argument("--num-processes", type=int, default=0)
    ap.add_argument("--process-id", type=int, default=-1)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="torch.distributed backend (default: nccl, or gloo "
                         "under --cpu)")
    return ap.parse_args(argv)


def _gather(obj, grouped: bool) -> list:
    """Every rank's obj, in rank order (this rank's alone without a group)."""
    if not grouped:
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _launches() -> dict[str, int]:
    counts = {**_fk.launch_counts(), **_mk.launch_counts()}
    return {name: n for name, n in counts.items() if n}


def main(argv=None) -> None:
    args = _parse(argv)
    backend = args.backend or ("gloo" if args.cpu else "nccl")
    if args.coordinator or args.num_processes:
        initialize_distributed(
            args.coordinator, args.num_processes or None,
            args.process_id if args.process_id >= 0 else None, backend)
    elif os.environ.get("POD_AUTO_INIT"):
        dist.init_process_group(backend, init_method="env://")
    grouped = dist.is_initialized()
    world, rank = (dist.get_world_size(), dist.get_rank()) if grouped else (1, 0)

    if args.cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise SystemExit("pod_msm runs each rank on a CUDA card and none is "
                             "available; pass --cpu to run on the CPU")
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    config.set_default_device(device)

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def barrier(group) -> None:
        if backend == "nccl":
            dist.barrier(group=group, device_ids=[device.index])
        else:
            dist.barrier(group=group)

    n = 1 << args.log2n
    c = args.c or (auto_c_dense(n) if args.dense else auto_c(n))
    if rank == 0:
        print(json.dumps({"n": n, "c": c, "n_devices": world,
                          "n_processes": world, "platform": device.type}),
              flush=True)

    where = _gather((socket.gethostname(),
                     str(torch.cuda.get_device_properties(device).uuid)
                     if device.type == "cuda" else "cpu"), grouped)
    shared = args.cpu or len(set(where)) < world
    sizes = [d for d in MESH_SIZES if d <= world and n % d == 0]
    if len({host for host, _ in where}) > 1:
        sizes = [world]               # several hosts: the global mesh only

    _fk.reset_launch_counts()
    _mk.reset_launch_counts()
    pts, scalars = make_inputs(n, SEED, device)
    sync()

    results = []
    ref_enc = None
    for nd in sizes:
        mesh = make_mesh(MeshConfig(n_devices=nd), devices=device)
        if mesh is not None:
            shard = batch_sharding(mesh)
            pts_s = EdwardsPoint(*(shard(co) for co in pts._tuple()))
            sc_s = Scalar(shard(scalars.limbs))

            def run():
                return msm_sharded(pts_s, sc_s, mesh, c=c, dense=args.dense,
                                   shard_combine=args.shard_combine)

            enc = bytes(RistrettoPoint(run()).compress().cpu().tolist())
            ref_enc = ref_enc or enc
            if enc != ref_enc:
                raise AssertionError(f"mesh size {nd}: the result differs "
                                     f"from mesh size {sizes[0]}'s")
            ts = []
            for _ in range(args.iters):
                if mesh.group is not None:
                    barrier(mesh.group)
                t0 = time.perf_counter()
                run()
                sync()
                ts.append(time.perf_counter() - t0)
            t = sorted(ts)[len(ts) // 2]
            results.append((nd, t))
            if rank == 0:
                print(json.dumps({"mesh": nd, "wall_s": t,
                                  "points_per_s": n / t}), flush=True)
        if grouped:
            barrier(None)

    per_rank = _gather({"rank": rank, "launches": _launches(),
                        "peak_bytes": torch.cuda.max_memory_allocated(device)
                        if device.type == "cuda" else None}, grouped)
    if rank == 0:
        t1 = results[0][1]
        for nd, t in results[1:]:
            print(json.dumps({"mesh": nd, "scaling_efficiency": t1 / (nd * t),
                              "note": SHARED if shared else backend}),
                  flush=True)
        print(json.dumps({"bit_exact_across_meshes": True,
                          "encoding": ref_enc.hex()}), flush=True)
        for line in per_rank:
            print(json.dumps(line), flush=True)
    if grouped:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
