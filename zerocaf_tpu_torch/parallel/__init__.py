"""Parallelism layer (zerocaf_tpu/parallel counterpart): the mesh of
ranks, collectives, MSM on one device or sharded over the mesh, and
checkpointing."""

from . import checkpoint
from .comm import Communicator
from .mesh import batch_sharding, initialize_distributed, make_mesh, replicated
from .msm import msm, msm_naive, msm_sharded

__all__ = [
    "Communicator", "batch_sharding", "initialize_distributed", "make_mesh",
    "replicated", "msm", "msm_naive", "msm_sharded", "checkpoint",
]
