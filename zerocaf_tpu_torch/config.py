"""Limb layout of the PyTorch port (zerocaf_tpu/config.py counterpart).

The port keeps the reference's tensor boundary: int32 ``[..., 22]`` limbs,
radix 2^12, limb axis last.  Every schoolbook column of two 12-bit-limb
operands stays inside a signed int32 (22 * 2^24 < 2^28.5), which is what the
hand-written CUDA kernels and their plain PyTorch versions both rely on.

There is no ``use_pallas`` switch: a kernel wrapper launches its CUDA kernel
for a CUDA tensor and runs its plain version for a CPU tensor.
"""

from __future__ import annotations

RADIX_BITS: int = 12
LIMB_MASK: int = (1 << RADIX_BITS) - 1
NUM_LIMBS: int = 22
FOLD_LIMB: int = 21          # limbs[21:] hold bits >= 252
