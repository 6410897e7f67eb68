"""Batched Edwards points on the Sonny curve (zerocaf_tpu/models/edwards.py
counterpart, extended coordinates).

Every point is a batch: coordinates are int32 ``[..., 22]`` limb tensors.
The unified a = -1 HWCD addition is complete on this curve, so identity and
equal operands need no special case.  Scalar multiplication runs on the
kernels of ``ops/kernels/field_kernels.py``: ``__mul__`` is the 250-step
oblivious ladder (K3 at width 1), ``mul_windowed`` the signed width-4
windows (K4).  Both read every table entry at every step; no access is
indexed by a secret digit.  The JAX package's ``take_along_axis`` windowed
path is not ported: it is not oblivious (docs/CONSTANT_TIME.md).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import constants as C
from ..ops import limb as _l
from ..ops.kernels import field_kernels as _fk
from ..ops.limb import FIELD as _F
from ..scalar import Scalar


def _add(p, q):
    """Unified HWCD a = -1 addition, 10M."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = _l.mul(X1, X2, _F)
    B = _l.mul(Y1, Y2, _F)
    Cc = _l.mul(_l.const(C.EDWARDS_D_LIMBS, X1.device), _l.mul(T1, T2, _F), _F)
    Dd = _l.mul(Z1, Z2, _F)
    E = _l.sub(_l.sub(_l.mul(_l.add(X1, Y1), _l.add(X2, Y2), _F), A), B)
    F = _l.sub(Dd, Cc)
    G = _l.add(Dd, Cc)
    H = _l.add(B, A)
    return (_l.mul(E, F, _F), _l.mul(G, H, _F), _l.mul(F, G, _F),
            _l.mul(E, H, _F))


def _double(p, with_t: bool = True):
    """dbl-2008-hwcd doubling, 4M+4S (a = -1); reads X, Y, Z only."""
    X, Y, Z = p[0], p[1], p[2]
    A = _l.square(X, _F)
    B = _l.square(Y, _F)
    Zs = _l.square(Z, _F)
    Cc = _l.add(Zs, Zs)
    Dd = _l.neg(A)
    E = _l.sub(_l.sub(_l.square(_l.add(X, Y), _F), A), B)
    G = _l.add(Dd, B)
    F = _l.sub(G, Cc)
    H = _l.sub(Dd, B)
    out = (_l.mul(E, F, _F), _l.mul(G, H, _F), _l.mul(F, G, _F))
    return out + (_l.mul(E, H, _F),) if with_t else out


def _neg(p):
    X, Y, Z, T = p
    return (_l.neg(X), Y, Z, _l.neg(T))


def _select(mask, p, q):
    return tuple(_l.select(mask, a, b) for a, b in zip(p, q))


_identity_like = _fk.identity_like


def _broadcast_point(p, digit_batch):
    """Broadcast point coordinates to the joint batch of point and digits,
    contiguous, as the kernels take them."""
    batch = torch.broadcast_shapes(p[0].shape[:-1], tuple(digit_batch))
    return tuple(c.expand(*batch, c.shape[-1]).contiguous() for c in p)


def _const_point(limbs, shape, device):
    return tuple(_l.const(limbs[i], device).expand(*shape, _l.L)
                 for i in range(4))


_BASEPOINT_ROWS = tuple(C.BASEPOINT[i].copy() for i in range(4))
_IDENTITY_ROWS = tuple(C.IDENTITY[i].copy() for i in range(4))


@dataclasses.dataclass(frozen=True)
class EdwardsPoint:
    """Batch of points in extended coordinates; fields are int32 [..., 22]."""

    X: torch.Tensor
    Y: torch.Tensor
    Z: torch.Tensor
    T: torch.Tensor

    # -- constructors -------------------------------------------------------
    @classmethod
    def identity(cls, shape: tuple[int, ...] = (), device=None) -> "EdwardsPoint":
        return cls(*_const_point(_IDENTITY_ROWS, tuple(shape), device))

    @classmethod
    def basepoint(cls, shape: tuple[int, ...] = (), device=None) -> "EdwardsPoint":
        return cls(*_const_point(_BASEPOINT_ROWS, tuple(shape), device))

    # -- group ops ----------------------------------------------------------
    def _tuple(self):
        return (self.X, self.Y, self.Z, self.T)

    def __add__(self, other: "EdwardsPoint") -> "EdwardsPoint":
        return EdwardsPoint(*_add(self._tuple(), other._tuple()))

    def __sub__(self, other: "EdwardsPoint") -> "EdwardsPoint":
        return EdwardsPoint(*_add(self._tuple(), _neg(other._tuple())))

    def __neg__(self) -> "EdwardsPoint":
        return EdwardsPoint(*_neg(self._tuple()))

    def double(self) -> "EdwardsPoint":
        return EdwardsPoint(*_double(self._tuple()))

    def __mul__(self, scalar: Scalar) -> "EdwardsPoint":
        """Fixed 250-step ladder: per bit one doubling and a Niels addition
        of a one-hot pick from {identity, P} (K3 at width 1)."""
        bits = scalar.into_bits(250)
        pt = _broadcast_point(self._tuple(), bits.shape[:-1])
        return EdwardsPoint(*_fk.scalar_mul_windowed_stepped(pt, bits, 1))

    def __rmul__(self, scalar: Scalar) -> "EdwardsPoint":
        return self.__mul__(scalar)

    def mul_windowed(self, scalar: Scalar, width: int = 4) -> "EdwardsPoint":
        """Signed fixed-window multiplication (K4): ceil(250/width) windows,
        a (2^(width-1)+1)-entry table read in full at every window."""
        windows = scalar.windows(width, -(-250 // width))
        pt = _broadcast_point(self._tuple(), windows.shape[:-1])
        return EdwardsPoint(*_fk.scalar_mul_windowed_signed(pt, windows, width))

    # -- observation --------------------------------------------------------
    @property
    def shape(self):
        return tuple(self.X.shape[:-1])

    def eq(self, other: "EdwardsPoint") -> torch.Tensor:
        """Projective equality: X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1."""
        X1, Y1, Z1, _ = self._tuple()
        X2, Y2, Z2, _ = other._tuple()
        ex = _l.eq(_l.mul(X1, Z2, _F), _l.mul(X2, Z1, _F), _F)
        ey = _l.eq(_l.mul(Y1, Z2, _F), _l.mul(Y2, Z1, _F), _F)
        return ex & ey

    def is_valid(self) -> torch.Tensor:
        """(-X^2 + Y^2) Z^2 == Z^4 + d X^2 Y^2 and T Z == X Y."""
        X, Y, Z, T = self._tuple()
        xs = _l.square(X, _F)
        ys = _l.square(Y, _F)
        zs = _l.square(Z, _F)
        left = _l.mul(_l.sub(ys, xs), zs, _F)
        right = _l.add(_l.square(zs, _F),
                       _l.mul(_l.const(C.EDWARDS_D_LIMBS, X.device),
                              _l.mul(xs, ys, _F), _F))
        curve = _l.eq(left, right, _F)
        ext = _l.eq(_l.mul(T, Z, _F), _l.mul(X, Y, _F), _F)
        return curve & ext
