"""Parallelism layer (zerocaf_tpu/parallel counterpart): single-device
MSM.  The mesh, collectives, sharded MSM and checkpointing are later
slices (ROADMAP.md)."""

from .msm import msm, msm_naive

__all__ = ["msm", "msm_naive"]
