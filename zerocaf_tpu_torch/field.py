"""Batched field elements mod p = 2^252 + 27742317777372353535851937790883648493
(zerocaf_tpu/field.py counterpart).

A ``FieldElement`` wraps an int32 ``[..., 22]`` limb tensor; leading axes are
batch axes and every operation is data-parallel over them.  Elements
circulate semi-reduced; bytes, equality and positivity canonicalize.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import oracle
from .ops import inv_sqrt as _isq
from .ops import limb as _l
from .ops.limb import FIELD as _F


@dataclasses.dataclass(frozen=True)
class FieldElement:
    limbs: torch.Tensor  # [..., 22] int32

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_int(cls, v, device=None) -> "FieldElement":
        """Python int(s) mod p; a sequence gives a batch."""
        vals = np.ravel(np.asarray(v, dtype=object))
        arr = np.stack([_l.int_limbs(int(x) % oracle.P) for x in vals])
        arr = arr.reshape(*np.shape(v), _l.L)
        return cls(torch.as_tensor(arr, device=device))

    @classmethod
    def from_bytes(cls, b: torch.Tensor) -> "FieldElement":
        """[..., 32] uint8 little-endian; the raw 256-bit value mod p."""
        return cls(_l.from_bytes(b, _F))

    # -- shape plumbing -----------------------------------------------------
    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.limbs.shape[:-1])

    # -- ring ops -----------------------------------------------------------
    def __add__(self, other: "FieldElement") -> "FieldElement":
        return FieldElement(_l.add(self.limbs, other.limbs))

    def __sub__(self, other: "FieldElement") -> "FieldElement":
        return FieldElement(_l.sub(self.limbs, other.limbs))

    def __neg__(self) -> "FieldElement":
        return FieldElement(_l.neg(self.limbs))

    def __mul__(self, other: "FieldElement") -> "FieldElement":
        return FieldElement(_l.mul(self.limbs, other.limbs, _F))

    def square(self) -> "FieldElement":
        return FieldElement(_l.square(self.limbs, _F))

    def inverse(self) -> "FieldElement":
        """Fermat a^(p-2); zero maps to zero."""
        return FieldElement(_isq.inverse(self.limbs))

    # -- observation --------------------------------------------------------
    def canonical(self) -> "FieldElement":
        return FieldElement(_l.canonical(self.limbs, _F))

    def to_bytes(self) -> torch.Tensor:
        """Canonical 32-byte little-endian encoding [..., 32] uint8."""
        return _l.to_bytes(self.limbs, _F)

    def eq(self, other: "FieldElement") -> torch.Tensor:
        return _l.eq(self.limbs, other.limbs, _F)
