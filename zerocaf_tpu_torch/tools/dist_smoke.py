"""One rank of the two-process smoke (tools/dist_smoke.py counterpart):
real processes joined by ``torch.distributed``, each holding only its own
rows, run the sharded MSM's steps -- a local Pippenger partial, an
all_gather of the partials across the process boundary, a local tree
reduction -- and every rank checks the total against the big-int oracle.

    python -m zerocaf_tpu_torch.tools.dist_smoke PID NPROCS PORT \\
        [--device D] [--backend gloo|nccl]

Start one process a rank; they meet at localhost:PORT.  The device is by
default the card ``cuda:<PID mod visible cards>`` (``--device cpu`` runs on
the CPU), the backend gloo (ranks that share a card cannot take NCCL).
Each rank prints ``DIST_SMOKE_OK pid=.. nprocs=.. n=..`` when its total is
right.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from .. import config
from .. import constants as C
from .. import oracle as o
from .. import recode
from ..config import MeshConfig
from ..models.edwards import EdwardsPoint
from ..parallel import Communicator, initialize_distributed, make_mesh
from ..parallel.msm import _msm_local, _tree_reduce

N_PER = 8          # rows a rank
C_WIDTH = 4        # window bits


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m zerocaf_tpu_torch.tools.dist_smoke")
    ap.add_argument("pid", type=int)
    ap.add_argument("nprocs", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("--device", default=None,
                    help="this rank's device (default: cuda:<pid mod cards>)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    args = ap.parse_args(argv)
    pid, nprocs = args.pid, args.nprocs
    if args.device is not None:
        device = torch.device(args.device)
    elif torch.cuda.is_available():
        device = torch.device("cuda", pid % torch.cuda.device_count())
    else:
        raise SystemExit("dist_smoke runs on a CUDA card by default and none "
                         "is available; pass --device cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    config.set_default_device(device)

    initialize_distributed(f"localhost:{args.port}", nprocs, pid, args.backend)
    mesh = make_mesh(MeshConfig(n_devices=nprocs), devices=device)

    # Points k_i B and scalars k_i for k_i = 1..n; this rank builds only its
    # own rows.
    n, nwin = nprocs * N_PER, -(-251 // C_WIDTH)
    mine = range(pid * N_PER + 1, (pid + 1) * N_PER + 1)
    pts = np.stack([C.point_limbs(o.scalar_mul(o.BASEPOINT, k)) for k in mine])
    sk = np.stack([np.frombuffer(k.to_bytes(32, "little"), np.uint8) for k in mine])
    pt = tuple(torch.from_numpy(pts[:, j].astype(np.int32)).to(device)
               for j in range(4))
    win = torch.from_numpy(recode.windows(sk, C_WIDTH, nwin)).to(device)

    partial = _msm_local(pt, win, c=C_WIDTH, nwin=nwin)
    total = EdwardsPoint(*_tree_reduce(Communicator(mesh).all_gather_points(partial)))

    # the points are k_i B and the scalars k_i: the total is (sum k_i^2) B
    want = o.scalar_mul(o.BASEPOINT, sum(k * k for k in range(1, n + 1)) % o.R)
    got = tuple(int(v) for v in total.to_ints())
    if not o.point_eq(got, want):
        raise AssertionError(f"rank {pid}: {got} != {want}")
    print(f"DIST_SMOKE_OK pid={pid} nprocs={nprocs} n={n}", flush=True)
    if mesh.group is not None:
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
