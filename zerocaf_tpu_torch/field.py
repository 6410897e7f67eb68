"""Batched field elements mod p = 2^252 + 27742317777372353535851937790883648493
(zerocaf_tpu/field.py counterpart).

A ``FieldElement`` wraps an int32 ``[..., 22]`` limb tensor; leading axes are
batch axes and every operation is data-parallel over them.  Elements
circulate semi-reduced; bytes, equality, comparisons, positivity and
evenness canonicalize.  Constructors given no device use
``config.default_device()``.

On CUDA tensors products are the K1 kernel and the inverse, power,
Legendre and square-root chains the K2 kernel (``ops/inv_sqrt.py``,
``limb.pow_const``); a power by a per-lane exponent is ``limb.pow_batched``,
two K1 launches a bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import constants as C
from . import oracle
from .config import resolve_device
from .ops import inv_sqrt as _isq
from .ops import limb as _l
from .ops.limb import FIELD as _F


def mask_like(cond, like: torch.Tensor) -> torch.Tensor:
    """A select or sign mask (bool, int or tensor) on the device of ``like``."""
    return torch.as_tensor(cond, device=like.device)


def limbs_of_ints(vals, modulus: int, device) -> torch.Tensor:
    """Python int(s) mod ``modulus`` as canonical int32 [..., 22] limbs on
    ``device`` (None: the default device); a sequence gives a batch."""
    flat = np.ravel(np.asarray(vals, dtype=object))
    arr = np.stack([_l.int_limbs(int(x) % modulus) for x in flat])
    arr = arr.reshape(*np.shape(vals), _l.L)
    return torch.as_tensor(arr, device=resolve_device(device))


def random_bytes(generator: torch.Generator, shape, nbytes: int, device) -> torch.Tensor:
    """Uniform uint8 [*shape, nbytes] drawn from ``generator`` on its own
    device, then placed on ``device`` (None: the default device)."""
    raw = torch.randint(0, 256, tuple(shape) + (nbytes,), generator=generator,
                        dtype=torch.uint8, device=generator.device)
    return raw.to(resolve_device(device))


def shift_right(x: torch.Tensor, spec, k: int, nbits: int) -> torch.Tensor:
    """The canonical value of ``x`` shifted right by k bits (logical), as
    canonical limbs; values hold at most ``nbits`` bits."""
    if k < 0:
        raise ValueError(f"shift must be non-negative, got {k}")
    c = _l.canonical(x, spec)
    if k >= nbits:
        return torch.zeros_like(c)
    q, b = divmod(k, _l.W)
    hi = _l._pad(c[..., q:], q)                  # limb i + q at i
    nxt = _l._pad(c[..., q + 1:], q + 1)         # limb i + q + 1 at i
    return ((hi >> b) | (nxt << (_l.W - b))) & _l.MASK


@dataclasses.dataclass(frozen=True)
class FieldElement:
    limbs: torch.Tensor  # [..., 22] int32
    SPEC = _F            # the modulus (a class constant, not a field)

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_int(cls, v, device=None) -> "FieldElement":
        """Python int(s) mod p; a sequence gives a batch."""
        return cls(limbs_of_ints(v, oracle.P, device))

    @classmethod
    def zero(cls, device=None) -> "FieldElement":
        return cls.from_int(0, device)

    @classmethod
    def one(cls, device=None) -> "FieldElement":
        return cls.from_int(1, device)

    @classmethod
    def minus_one(cls, device=None) -> "FieldElement":
        return cls.from_int(C.P - 1, device)

    @classmethod
    def two_pow_k(cls, k: int, device=None) -> "FieldElement":
        """2^k for 0 <= k < 253."""
        if not 0 <= k < 253:
            raise ValueError(f"two_pow_k needs 0 <= k < 253, got {k}")
        return cls.from_int(1 << k, device)

    @classmethod
    def from_bytes(cls, b: torch.Tensor) -> "FieldElement":
        """[..., 32] uint8 little-endian; the raw 256-bit value mod p."""
        return cls(_l.from_bytes(b, _F))

    @classmethod
    def from_ristretto255_scalar_bytes(cls, b: torch.Tensor) -> "FieldElement":
        """A canonical ristretto255 scalar's bytes: p is the ristretto255
        group order, so such a scalar is a canonical element of this field
        and the conversion is the byte decode."""
        return cls.from_bytes(b)

    def to_ristretto255_scalar_bytes(self) -> torch.Tensor:
        return self.to_bytes()

    @classmethod
    def random(cls, generator: torch.Generator, shape: tuple[int, ...] = (),
               device=None) -> "FieldElement":
        """Uniform elements: 64 bytes drawn from ``generator`` (on the
        generator's device), reduced mod p, placed on ``device``."""
        b = random_bytes(generator, shape, 64, device)
        lo = _l.from_bytes(b[..., :32], _F)
        hi = _l.from_bytes(b[..., 32:], _F)
        return cls(_l.add(_l.mul(hi, _l.const(_SHIFT_256, b.device), _F), lo))

    # -- shape plumbing -----------------------------------------------------
    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.limbs.shape[:-1])

    def __getitem__(self, idx) -> "FieldElement":
        return FieldElement(self.limbs[idx])

    def broadcast_to(self, shape) -> "FieldElement":
        return FieldElement(self.limbs.expand(*tuple(shape), _l.L))

    # -- ring ops -----------------------------------------------------------
    def __add__(self, other: "FieldElement") -> "FieldElement":
        return FieldElement(_l.add(self.limbs, other.limbs))

    def __sub__(self, other: "FieldElement") -> "FieldElement":
        return FieldElement(_l.sub(self.limbs, other.limbs))

    def __neg__(self) -> "FieldElement":
        return FieldElement(_l.neg(self.limbs))

    def __mul__(self, other: "FieldElement") -> "FieldElement":
        return FieldElement(_l.mul(self.limbs, other.limbs, _F))

    def __truediv__(self, other: "FieldElement") -> "FieldElement":
        """x * y^-1; division by zero gives zero (check ``is_zero``)."""
        return self * other.inverse()

    def square(self) -> "FieldElement":
        return FieldElement(_l.square(self.limbs, _F))

    def half(self) -> "FieldElement":
        """x / 2 mod p."""
        return FieldElement(_l.mul(self.limbs, _l.const(_HALF, self.limbs.device),
                                   _F))

    def __rshift__(self, k: int) -> "FieldElement":
        """Logical right shift of the canonical value."""
        return FieldElement(shift_right(self.limbs, _F, k, 253))

    def half_without_mod(self) -> "FieldElement":
        """Exact halving of an even element: the value shifted right by 1."""
        return self >> 1

    def inverse(self) -> "FieldElement":
        """Fermat a^(p-2); zero maps to zero."""
        return FieldElement(_isq.inverse(self.limbs))

    def pow(self, exp) -> "FieldElement":
        """a^e: a python-int exponent runs a fixed chain (K2 for 32 bits or
        more); a FieldElement or Scalar exponent a 253-step ladder over its
        canonical bits (``limb.pow_batched``)."""
        if isinstance(exp, int):
            return FieldElement(_l.pow_const(self.limbs, exp, _F))
        bits = _l.to_bits(exp.limbs, exp.SPEC, 253)
        return FieldElement(_l.pow_batched(self.limbs, bits, _F))

    # -- square roots -------------------------------------------------------
    def legendre_symbol(self) -> torch.Tensor:
        """True for a nonzero quadratic residue; False for a non-residue and
        for zero (``legendre_symbol_value`` tells them apart)."""
        return _isq.legendre_is_qr(self.limbs)

    def legendre_symbol_value(self) -> "FieldElement":
        """a^((p-1)/2): 1, p - 1 or 0."""
        return FieldElement(_l.pow_const(self.limbs, C.EXP_LEGENDRE, _F))

    def mod_sqrt(self, sign) -> tuple[torch.Tensor, "FieldElement"]:
        """(exists, root): sign 0 gives the raw Tonelli root, 1 its
        negation, as in the reference."""
        ok, root = _isq.mod_sqrt(self.limbs, mask_like(sign, self.limbs))
        return ok, FieldElement(root)

    def inv_sqrt(self) -> tuple[torch.Tensor, "FieldElement"]:
        ok, r = _isq.inv_sqrt(self.limbs)
        return ok, FieldElement(r)

    def sqrt_ratio_i(self, v: "FieldElement") -> tuple[torch.Tensor, "FieldElement"]:
        ok, r = _isq.sqrt_ratio_i(self.limbs, v.limbs)
        return ok, FieldElement(r)

    # -- observation --------------------------------------------------------
    def canonical(self) -> "FieldElement":
        return FieldElement(_l.canonical(self.limbs, _F))

    def to_bytes(self) -> torch.Tensor:
        """Canonical 32-byte little-endian encoding [..., 32] uint8."""
        return _l.to_bytes(self.limbs, _F)

    def eq(self, other: "FieldElement") -> torch.Tensor:
        return _l.eq(self.limbs, other.limbs, _F)

    def cmp(self, other: "FieldElement") -> torch.Tensor:
        """Three-way compare of the canonical values: -1 / 0 / +1 int32."""
        return _l.cmp(self.limbs, other.limbs, _F)

    def __lt__(self, other: "FieldElement") -> torch.Tensor:
        return self.cmp(other) < 0

    def __le__(self, other: "FieldElement") -> torch.Tensor:
        return self.cmp(other) <= 0

    def __gt__(self, other: "FieldElement") -> torch.Tensor:
        return self.cmp(other) > 0

    def __ge__(self, other: "FieldElement") -> torch.Tensor:
        return self.cmp(other) >= 0

    def is_zero(self) -> torch.Tensor:
        return _l.is_zero(self.limbs, _F)

    def is_positive(self) -> torch.Tensor:
        """Decaf non-negativity: canonical value <= (p-1)/2."""
        return _isq.is_positive(self.limbs)

    def abs(self) -> "FieldElement":
        return FieldElement(_isq.abs_positive(self.limbs))

    def is_even(self) -> torch.Tensor:
        return (_l.canonical(self.limbs, _F)[..., 0] & 1) == 0

    def conditional_negate(self, cond) -> "FieldElement":
        return FieldElement(_isq.conditional_negate(
            self.limbs, mask_like(cond, self.limbs).to(torch.bool)))

    def select(self, cond, other: "FieldElement") -> "FieldElement":
        """where(cond, self, other), limbwise."""
        return FieldElement(_l.select(mask_like(cond, self.limbs).to(torch.bool),
                                      self.limbs, other.limbs))

    def to_ints(self):
        """Canonical values as python ints (host pull; tests only)."""
        return ints_of_limbs(self.limbs, _F)

    def __repr__(self) -> str:
        return f"FieldElement(shape={self.shape}, device={self.limbs.device})"


def ints_of_limbs(x: torch.Tensor, spec):
    """Canonical values of [..., 22] limbs as a python int (one element) or
    an object array of them."""
    arr = _l.canonical(x, spec).cpu().numpy()
    flat = [oracle.limbs_to_int(row) for row in arr.reshape(-1, _l.L)]
    return flat[0] if arr.ndim == 1 else np.array(
        flat, dtype=object).reshape(arr.shape[:-1])


_SHIFT_256 = _l.int_limbs(pow(2, 256, oracle.P))
_HALF = _l.int_limbs(C.INVERSE_MOD_TWO)
