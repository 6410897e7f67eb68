"""The mesh of ranks that sharded curve workloads run on
(zerocaf_tpu/parallel/mesh.py counterpart).

The JAX package's mesh is one program over many devices; here it is one
process per rank under ``torch.distributed``, each on one device.  A 1-D
``data`` axis splits the point and scalar batch of MSM over the ranks.
With no process group initialised the mesh has one rank and the
collectives of ``parallel/comm.py`` are local.  A mesh may also span only
the first ranks of the group (a sub-mesh, as the JAX package's mesh may
take only the first devices).  Nothing is read from the
environment beyond ``torch.distributed``'s own state: the caller passes
the rendezvous to ``initialize_distributed`` and, where it is not
``cuda:<local rank>``, the device to ``make_mesh``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..config import MeshConfig


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D mesh: the process group (None for a
    one-rank mesh without one), its size, this rank, the axis name, and
    the device this rank computes on."""

    group: object
    size: int
    rank: int
    axis: str
    device: torch.device


def _device(device) -> torch.device:
    """A torch.device with its index: ``cuda`` means the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(cfg: MeshConfig | None = None, devices=None) -> Mesh | None:
    """The 1-D mesh over the first cfg.n_devices ranks of the initialised
    process group (the world), or a one-rank mesh when none is
    initialised.  cfg.n_devices=None takes every rank.  A smaller d gives
    ranks 0..d-1 a mesh of size d over the group ``dist.new_group(range(d))``
    (none at d = 1: a one-rank mesh whose collectives are local), and every
    other rank None: it takes no part in that mesh's collectives.  Creating
    a group is collective over the world, so every rank calls make_mesh
    with the same cfg, in the same order.  A d larger than the world
    raises.  This rank computes on ``devices`` (one device, for this rank)
    if given, else on ``cuda:<rank mod visible cards>``; without CUDA a
    device must be given."""
    cfg = cfg or MeshConfig()
    grouped = dist.is_available() and dist.is_initialized()
    world, rank = (dist.get_world_size(), dist.get_rank()) if grouped else (1, 0)
    size = world if cfg.n_devices is None else cfg.n_devices
    if not 1 <= size <= world:
        raise ValueError(f"make_mesh: n_devices={cfg.n_devices}, but the "
                         f"process group has {world} ranks")
    if grouped and size == world:
        group = dist.group.WORLD
    elif size == 1:
        group = None
    else:
        group = dist.new_group(list(range(size)))
    if rank >= size:
        return None
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() puts each rank on a CUDA card and "
                               "none is available; pass devices='cpu'")
        devices = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(group, size, rank, cfg.data_axis, _device(devices))


def batch_sharding(mesh: Mesh, axis: str = "data"):
    """Sharding of [N, ...] tensors over the mesh axis: the returned
    function gives this rank its contiguous block of a global tensor, on
    this rank's device.  N must be divisible by the mesh size."""
    if axis != mesh.axis:
        raise ValueError(f"batch_sharding: axis {axis!r}, mesh axis {mesh.axis!r}")

    def shard(x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        if n % mesh.size:
            raise ValueError(f"batch_sharding: {n} rows do not divide over "
                             f"{mesh.size} ranks")
        block = n // mesh.size
        return x[mesh.rank * block:(mesh.rank + 1) * block].to(mesh.device)

    return shard


def replicated(mesh: Mesh):
    """Replication over the mesh: the returned function puts a whole
    tensor on this rank's device."""

    def place(x: torch.Tensor) -> torch.Tensor:
        return x.to(mesh.device)

    return place


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str = "nccl") -> None:
    """Join this process to a group of num_processes ranks as rank
    process_id, meeting the others at ``coordinator`` ("host:port").  A
    no-op at one process.  The backend is the caller's choice and is
    never switched: "nccl" for CUDA ranks, "gloo" for CPU ranks (or CUDA
    ranks that share a card)."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator is None or process_id is None:
        raise ValueError("initialize_distributed: a coordinator and a "
                         "process_id are needed for several processes")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
