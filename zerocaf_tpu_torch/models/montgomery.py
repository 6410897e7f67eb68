"""The Montgomery form of the Sonny curve (zerocaf_tpu/models/montgomery.py
counterpart).

The birational maps to and from the Montgomery curve
B v^2 = u^3 + A u^2 + u, A = 2(a+d)/(a-d) = 505186:

    u = (Z + Y) / (Z - Y)            (Edwards -> Montgomery)
    y = (u - 1) / (u + 1)            (Montgomery -> Edwards y)

A ``MontgomeryPoint`` batch holds u-coordinates as [..., 32] uint8;
equality is field equality of the decoded u values.  Each map is one
inverse (K2 on CUDA); ``to_edwards`` adds the square root of the lift.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import constants as C
from ..field import FieldElement
from ..ops import inv_sqrt as _isq
from ..ops import limb as _l
from ..ops.limb import FIELD as _F
from . import edwards as _ed

MONT_A = C.MONT_A  # 505186
MONT_B = C.MONT_B


@dataclasses.dataclass(frozen=True)
class MontgomeryPoint:
    """A batch of u-coordinates as bytes."""

    bytes: torch.Tensor  # [..., 32] uint8

    @classmethod
    def from_edwards(cls, p: _ed.EdwardsPoint) -> "MontgomeryPoint":
        """u = (Z + Y) / (Z - Y).  The identity (Y = Z) maps to the point at
        infinity, encoded as u = 0: the inverse of zero is zero."""
        num = _l.add(p.Z, p.Y)
        den = _l.sub(p.Z, p.Y)
        return cls(_l.to_bytes(_l.mul(num, _isq.inverse(den), _F), _F))

    def u(self) -> FieldElement:
        return FieldElement(_l.from_bytes(self.bytes, _F))

    def to_edwards(self, sign) -> tuple[_ed.EdwardsPoint, torch.Tensor]:
        """y = (u - 1) / (u + 1), lifted with x's sign.  Returns (points,
        ok); ok is False where no curve point has that u."""
        uu = self.u().limbs
        one = _l.one_like(uu)
        y = _l.mul(_l.sub(uu, one), _isq.inverse(_l.add(uu, one)), _F)
        return _ed.EdwardsPoint.new_from_y_coord(FieldElement(y), sign)

    def eq(self, other: "MontgomeryPoint") -> torch.Tensor:
        """Equality mod p of the decoded u values."""
        return _l.eq(self.u().limbs, other.u().limbs, _F)

    def __repr__(self) -> str:
        return f"MontgomeryPoint(shape={tuple(self.bytes.shape[:-1])})"
