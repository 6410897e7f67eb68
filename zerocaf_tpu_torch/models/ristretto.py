"""Batched Ristretto prime-order group over the Sonny curve
(zerocaf_tpu/models/ristretto.py counterpart).

Encode, decode and Elligator are a handful of field multiplies plus one
``sqrt_ratio_i`` chain each (the K2 kernel on CUDA); every branch of the
reference is a limbwise select.  Encodings are byte-compatible with the
reference's vectors.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import constants as C
from ..config import resolve_device
from ..field import FieldElement, random_bytes
from ..ops import inv_sqrt as _isq
from ..ops import limb as _l
from ..ops.limb import FIELD as _F
from ..scalar import Scalar
from . import edwards as _ed


def _c(limbs, like: torch.Tensor) -> torch.Tensor:
    return _l.const(limbs, like.device)


def _compress(p) -> torch.Tensor:
    """Ristretto encode: 4-tuple of [..., 22] -> [..., 32] uint8."""
    X, Y, Z, T = p
    u1 = _l.mul(_l.add(Z, Y), _l.sub(Z, Y), _F)
    u2 = _l.mul(X, Y, _F)
    _, I = _isq.inv_sqrt(_l.mul(u1, _l.square(u2, _F), _F))
    D1 = _l.mul(u1, I, _F)
    D2 = _l.mul(u2, I, _F)
    Zinv = _l.mul(_l.mul(D1, D2, _F), T, _F)
    rotate = ~_isq.is_positive(_l.mul(T, Zinv, _F))
    sqrt_m1 = _c(C.SQRT_M1_LIMBS, X)
    x = _l.select(rotate, _l.mul(sqrt_m1, Y, _F), X)
    y = _l.select(rotate, _l.mul(sqrt_m1, X, _F), Y)
    Dde = _l.select(rotate, _l.mul(D1, _c(C.INV_SQRT_A_MINUS_D_LIMBS, X), _F), D2)
    y = _isq.conditional_negate(y, ~_isq.is_positive(_l.mul(x, Zinv, _F)))
    s = _l.mul(_l.sub(Z, y), Dde, _F)
    return _l.to_bytes(_isq.abs_positive(s), _F)


def _decompress(b: torch.Tensor):
    """Ristretto decode: [..., 32] uint8 -> (4-tuple point, ok).  ok is
    False for non-canonical or invalid encodings; those lanes hold garbage."""
    s = _l.from_bytes(b, _F)
    canonical_enc = torch.all(_l.to_bytes(s, _F) == b, dim=-1)
    s_pos = _isq.is_positive(s)

    one = _l.one_like(s)
    ss = _l.square(s, _F)
    u1 = _l.sub(one, ss)
    u2 = _l.add(one, ss)
    u2_sq = _l.square(u2, _F)
    v = _l.sub(_l.neg(_l.mul(_c(C.EDWARDS_D_LIMBS, s), _l.square(u1, _F), _F)),
               u2_sq)
    ok_sqrt, I = _isq.inv_sqrt(_l.mul(v, u2_sq, _F))
    Dx = _l.mul(I, u2, _F)
    Dy = _l.mul(I, _l.mul(Dx, v, _F), _F)
    x = _isq.abs_positive(_l.mul(_l.add(s, s), Dx, _F))
    y = _l.mul(u1, Dy, _F)
    t = _l.mul(x, y, _F)
    ok = (canonical_enc & s_pos & ok_sqrt
          & _isq.is_positive(t) & ~_l.is_zero(y, _F))
    return (x, y, one, t), ok


def _elligator(r0: torch.Tensor):
    """The Ristretto Elligator map: [..., 22] -> 4-tuple point."""
    d = _c(C.EDWARDS_D_LIMBS, r0)
    one = _l.one_like(r0)
    c = _l.neg(one)
    r = _l.mul(_c(C.SQRT_M1_LIMBS, r0), _l.square(r0, _F), _F)
    N_s = _l.mul(_l.add(r, one), _c(C.ONE_MINUS_D_SQ_LIMBS, r0), _F)
    D = _l.mul(_l.sub(c, _l.mul(d, r, _F)), _l.add(r, d), _F)
    Ns_D_is_sq, s = _isq.sqrt_ratio_i(N_s, D)

    s_prim = _l.mul(s, r0, _F)
    s_prim = _isq.conditional_negate(s_prim, _isq.is_positive(s_prim))
    s = _l.select(Ns_D_is_sq, s, s_prim)
    c = _l.select(Ns_D_is_sq, c, r)

    N_t = _l.sub(_l.mul(_l.mul(c, _l.sub(r, one), _F),
                        _c(C.D_MINUS_ONE_SQ_LIMBS, r0), _F), D)
    s_sq = _l.square(s, _F)
    W0 = _l.mul(_l.add(s, s), D, _F)
    W1 = _l.mul(N_t, _c(C.SQRT_AD_MINUS_ONE_LIMBS, r0), _F)
    W2 = _l.sub(one, s_sq)
    W3 = _l.add(one, s_sq)
    return (_l.mul(W0, W3, _F), _l.mul(W2, W1, _F),
            _l.mul(W1, W3, _F), _l.mul(W0, W2, _F))


def _ristretto_eq(p, q) -> torch.Tensor:
    """Coset-aware equality: X1 Y2 == Y1 X2 or X1 X2 == Y1 Y2."""
    X1, Y1, _, _ = p
    X2, Y2, _, _ = q
    a = _l.eq(_l.mul(X1, Y2, _F), _l.mul(Y1, X2, _F), _F)
    b = _l.eq(_l.mul(X1, X2, _F), _l.mul(Y1, Y2, _F), _F)
    return a | b


@dataclasses.dataclass(frozen=True)
class RistrettoPoint:
    """A batch of Ristretto points, represented by Edwards points."""

    point: _ed.EdwardsPoint

    @classmethod
    def identity(cls, shape: tuple[int, ...] = (), device=None) -> "RistrettoPoint":
        return cls(_ed.EdwardsPoint.identity(shape, device))

    @classmethod
    def basepoint(cls, shape: tuple[int, ...] = (), device=None) -> "RistrettoPoint":
        return cls(_ed.EdwardsPoint.basepoint(shape, device))

    @classmethod
    def elligator(cls, r0: FieldElement) -> "RistrettoPoint":
        return cls(_ed.EdwardsPoint(*_elligator(r0.limbs)))

    @classmethod
    def from_uniform_bytes(cls, b: torch.Tensor) -> "RistrettoPoint":
        """Hash-to-group: [..., 64] uint8 -> points (Elligator twice, then
        one addition)."""
        p1 = _elligator(_l.from_bytes(b[..., :32], _F))
        p2 = _elligator(_l.from_bytes(b[..., 32:], _F))
        return cls(_ed.EdwardsPoint(*_ed._add(p1, p2)))

    @classmethod
    def random(cls, generator: torch.Generator, shape: tuple[int, ...] = (),
               device=None) -> "RistrettoPoint":
        """Uniform points: Elligator twice on 64 bytes drawn from
        ``generator`` (on the generator's device), placed on ``device``."""
        return cls.from_uniform_bytes(random_bytes(generator, shape, 64, device))

    def __add__(self, other: "RistrettoPoint") -> "RistrettoPoint":
        return RistrettoPoint(self.point + other.point)

    def __sub__(self, other: "RistrettoPoint") -> "RistrettoPoint":
        return RistrettoPoint(self.point - other.point)

    def __neg__(self) -> "RistrettoPoint":
        return RistrettoPoint(-self.point)

    def double(self) -> "RistrettoPoint":
        return RistrettoPoint(self.point.double())

    def __mul__(self, scalar: Scalar) -> "RistrettoPoint":
        return RistrettoPoint(self.point * scalar)

    def __rmul__(self, scalar: Scalar) -> "RistrettoPoint":
        return self.__mul__(scalar)

    def compress(self) -> torch.Tensor:
        """[..., 32] uint8 canonical encodings."""
        return _compress(self.point._tuple())

    @classmethod
    def decompress(cls, b: torch.Tensor) -> tuple["RistrettoPoint", torch.Tensor]:
        """(points, ok): ok is False for non-canonical or invalid encodings."""
        pt, ok = _decompress(b)
        return cls(_ed.EdwardsPoint(*pt)), ok

    @property
    def shape(self):
        return self.point.shape

    def __getitem__(self, idx) -> "RistrettoPoint":
        return RistrettoPoint(self.point[idx])

    def eq(self, other: "RistrettoPoint") -> torch.Tensor:
        return _ristretto_eq(self.point._tuple(), other.point._tuple())

    def is_valid(self) -> torch.Tensor:
        """Strict order-r validity: on the curve and r P == identity (the
        ladder over r's 253 bits: K3 at 253 windows on CUDA)."""
        rp = self.point.mul_raw_int(C.R)
        ident = _ed.EdwardsPoint.identity(self.shape, self.point.X.device)
        return self.point.is_valid() & rp.eq(ident)

    def coset4(self) -> list[_ed.EdwardsPoint]:
        return self.point.coset4()

    def __repr__(self) -> str:
        return f"RistrettoPoint(shape={self.shape}, device={self.point.X.device})"


@dataclasses.dataclass(frozen=True)
class CompressedRistretto:
    """The canonical 32-byte wire format; equality is byte equality."""

    bytes: torch.Tensor  # [..., 32] uint8

    @classmethod
    def identity(cls, shape: tuple[int, ...] = (), device=None) -> "CompressedRistretto":
        return cls(torch.zeros(tuple(shape) + (32,), dtype=torch.uint8,
                               device=resolve_device(device)))

    def decompress(self) -> tuple[RistrettoPoint, torch.Tensor]:
        return RistrettoPoint.decompress(self.bytes)

    def eq(self, other: "CompressedRistretto") -> torch.Tensor:
        return torch.all(self.bytes == other.bytes, dim=-1)

    def __repr__(self) -> str:
        return f"CompressedRistretto(shape={tuple(self.bytes.shape[:-1])})"
