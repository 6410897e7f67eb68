"""Limb layout of the PyTorch port (zerocaf_tpu/config.py counterpart).

The port keeps the reference's tensor boundary: int32 ``[..., 22]`` limbs,
radix 2^12, limb axis last.  Every schoolbook column of two 12-bit-limb
operands stays inside a signed int32 (22 * 2^24 < 2^28.5), which is what the
hand-written CUDA kernels and their plain PyTorch versions both rely on.

``MeshConfig`` describes the mesh of ranks that sharded MSM runs on.

There is no ``use_pallas`` switch: a kernel wrapper launches its CUDA kernel
for a CUDA tensor and runs its plain version for a CPU tensor.
"""

from __future__ import annotations

import dataclasses

RADIX_BITS: int = 12
LIMB_MASK: int = (1 << RADIX_BITS) - 1
NUM_LIMBS: int = 22
FOLD_LIMB: int = 21          # limbs[21:] hold bits >= 252


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Layout of the mesh that sharded workloads (MSM) run on: one axis,
    ``data_axis``, that splits the point and scalar batch over the ranks of
    ``torch.distributed``.  n_devices=None takes every rank; a number must
    equal the world size (``parallel.mesh.make_mesh``)."""

    data_axis: str = "data"
    n_devices: int | None = None
