"""Batched field elements mod p = 2^252 + 27742317777372353535851937790883648493
(zerocaf_tpu/field.py counterpart).

A ``FieldElement`` wraps a ``[..., nlimbs]`` limb tensor and carries its
``spec``, the limb backend's ``ModSpec``: int32 ``[..., 22]`` on i32x22 (the
default), float32 ``[..., 29]`` on f32x29.  Leading axes are batch axes and
every operation is data-parallel over them.  Elements circulate
semi-reduced; bytes, equality, comparisons, positivity and evenness
canonicalize.  Constructors given no device use ``config.default_device()``;
given no ``spec``, the active backend's (``config.get_backend()``).

On CUDA tensors the i32x22 products are the K1 kernel and the inverse,
power, Legendre and square-root chains the K2 kernel (``ops/inv_sqrt.py``,
``limb.pow_const``); a power by a per-lane exponent is ``limb.pow_batched``,
two K1 launches a bit.  The f32x29 backend is plain PyTorch on every device.

The module constants (``EDWARDS_D``, ``SQRT_M1`` and the others of the JAX
package's field module) are built on access, on ``config.default_device()``,
so that importing the package touches no device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import config as _cfg
from . import constants as C
from . import oracle
from .config import resolve_device
from .ops import inv_sqrt as _isq
from .ops import limb as _l
from .ops.limb import FIELD as _F
from .ops.limb import ModSpec


def _field_spec(spec: ModSpec | None) -> ModSpec:
    """``spec``, or the active backend's field spec for None."""
    return spec if spec is not None else _l.BACKENDS[_cfg.get_backend()][0]


def mask_like(cond, like: torch.Tensor) -> torch.Tensor:
    """A select or sign mask (bool, int or tensor) on the device of ``like``."""
    return torch.as_tensor(cond, device=like.device)


def limbs_of_ints(vals, spec: ModSpec, device) -> torch.Tensor:
    """Python int(s) mod ``spec.m`` as canonical ``[..., nlimbs]`` limbs of
    ``spec`` on ``device`` (None: the default device); a sequence gives a
    batch."""
    flat = np.ravel(np.asarray(vals, dtype=object))
    arr = np.array([oracle.int_to_limbs(int(x) % spec.m, n=spec.nlimbs,
                                        w=spec.wbits) for x in flat], np.int32)
    arr = arr.reshape(*np.shape(vals), spec.nlimbs)
    return torch.as_tensor(arr, device=resolve_device(device), dtype=spec.dtype)


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
    c = _l.canonical(x, spec).to(torch.int32)
    if k >= nbits:
        return torch.zeros_like(x)
    w = spec.wbits
    q, b = divmod(k, w)
    hi = _l._pad(c[..., q:], q)                  # limb i + q at i
    nxt = _l._pad(c[..., q + 1:], q + 1)         # limb i + q + 1 at i
    return (((hi >> b) | (nxt << (w - b))) & ((1 << w) - 1)).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class FieldElement:
    limbs: torch.Tensor  # [..., spec.nlimbs] of spec.dtype
    spec: ModSpec = _F   # the limb backend (i32x22 unless given)

    def _new(self, limbs: torch.Tensor) -> "FieldElement":
        return FieldElement(limbs, self.spec)

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_int(cls, v, device=None, spec: ModSpec | None = None) -> "FieldElement":
        """Python int(s) mod p; a sequence gives a batch."""
        s = _field_spec(spec)
        return cls(limbs_of_ints(v, s, device), s)

    @classmethod
    def zero(cls, device=None, spec: ModSpec | None = None) -> "FieldElement":
        return cls.from_int(0, device, spec)

    @classmethod
    def one(cls, device=None, spec: ModSpec | None = None) -> "FieldElement":
        return cls.from_int(1, device, spec)

    @classmethod
    def minus_one(cls, device=None, spec: ModSpec | None = None) -> "FieldElement":
        return cls.from_int(C.P - 1, device, spec)

    @classmethod
    def two_pow_k(cls, k: int, device=None,
                  spec: ModSpec | None = None) -> "FieldElement":
        """2^k for 0 <= k < 253."""
        if not 0 <= k < 253:
            raise ValueError(f"two_pow_k needs 0 <= k < 253, got {k}")
        return cls.from_int(1 << k, device, spec)

    @classmethod
    def from_bytes(cls, b: torch.Tensor, spec: ModSpec | None = None) -> "FieldElement":
        """[..., 32] uint8 little-endian; the raw 256-bit value mod p."""
        s = _field_spec(spec)
        return cls(_l.from_bytes(b, s), s)

    @classmethod
    def from_ristretto255_scalar_bytes(cls, b: torch.Tensor,
                                       spec: ModSpec | None = None) -> "FieldElement":
        """A canonical ristretto255 scalar's bytes: p is the ristretto255
        group order, so such a scalar is a canonical element of this field
        and the conversion is the byte decode."""
        return cls.from_bytes(b, spec)

    def to_ristretto255_scalar_bytes(self) -> torch.Tensor:
        return self.to_bytes()

    @classmethod
    def random(cls, generator: torch.Generator, shape: tuple[int, ...] = (),
               device=None, spec: ModSpec | None = None) -> "FieldElement":
        """Uniform elements: 64 bytes drawn from ``generator`` (on the
        generator's device), reduced mod p, placed on ``device``."""
        s = _field_spec(spec)
        b = random_bytes(generator, shape, 64, device)
        lo = _l.from_bytes(b[..., :32], s)
        hi = _l.from_bytes(b[..., 32:], s)
        shift = _l.const_int(pow(2, 256, C.P), s, b.device)
        return cls(_l.add(_l.mul(hi, shift, s), lo), s)

    # -- shape plumbing -----------------------------------------------------
    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.limbs.shape[:-1])

    def __getitem__(self, idx) -> "FieldElement":
        return self._new(self.limbs[idx])

    def broadcast_to(self, shape) -> "FieldElement":
        return self._new(self.limbs.expand(*tuple(shape), self.spec.nlimbs))

    # -- ring ops -----------------------------------------------------------
    def __add__(self, other: "FieldElement") -> "FieldElement":
        return self._new(_l.add(self.limbs, other.limbs))

    def __sub__(self, other: "FieldElement") -> "FieldElement":
        return self._new(_l.sub(self.limbs, other.limbs))

    def __neg__(self) -> "FieldElement":
        return self._new(_l.neg(self.limbs))

    def __mul__(self, other: "FieldElement") -> "FieldElement":
        return self._new(_l.mul(self.limbs, other.limbs, self.spec))

    def __truediv__(self, other: "FieldElement") -> "FieldElement":
        """x * y^-1; division by zero gives zero (check ``is_zero``)."""
        return self * other.inverse()

    def square(self) -> "FieldElement":
        return self._new(_l.square(self.limbs, self.spec))

    def half(self) -> "FieldElement":
        """x / 2 mod p."""
        half = _l.const_int(C.INVERSE_MOD_TWO, self.spec, self.limbs.device)
        return self._new(_l.mul(self.limbs, half, self.spec))

    def __rshift__(self, k: int) -> "FieldElement":
        """Logical right shift of the canonical value."""
        return self._new(shift_right(self.limbs, self.spec, k, 253))

    def half_without_mod(self) -> "FieldElement":
        """Exact halving of an even element: the value shifted right by 1."""
        return self >> 1

    def inverse(self) -> "FieldElement":
        """Fermat a^(p-2); zero maps to zero."""
        return self._new(_isq.inverse(self.limbs, self.spec))

    def pow(self, exp) -> "FieldElement":
        """a^e: a python-int exponent runs a fixed chain (K2 for 32 bits or
        more on i32x22); a FieldElement or Scalar exponent a 253-step ladder
        over its canonical bits (``limb.pow_batched``)."""
        if isinstance(exp, int):
            return self._new(_l.pow_const(self.limbs, exp, self.spec))
        bits = _l.to_bits(exp.limbs, exp.spec, 253)
        return self._new(_l.pow_batched(self.limbs, bits, self.spec))

    # -- square roots -------------------------------------------------------
    def legendre_symbol(self) -> torch.Tensor:
        """True for a nonzero quadratic residue; False for a non-residue and
        for zero (``legendre_symbol_value`` tells them apart)."""
        return _isq.legendre_is_qr(self.limbs, self.spec)

    def legendre_symbol_value(self) -> "FieldElement":
        """a^((p-1)/2): 1, p - 1 or 0."""
        return self._new(_l.pow_const(self.limbs, C.EXP_LEGENDRE, self.spec))

    def mod_sqrt(self, sign) -> tuple[torch.Tensor, "FieldElement"]:
        """(exists, root): sign 0 gives the raw Tonelli root, 1 its
        negation, as in the reference."""
        ok, root = _isq.mod_sqrt(self.limbs, mask_like(sign, self.limbs),
                                 self.spec)
        return ok, self._new(root)

    def inv_sqrt(self) -> tuple[torch.Tensor, "FieldElement"]:
        ok, r = _isq.inv_sqrt(self.limbs, self.spec)
        return ok, self._new(r)

    def sqrt_ratio_i(self, v: "FieldElement") -> tuple[torch.Tensor, "FieldElement"]:
        ok, r = _isq.sqrt_ratio_i(self.limbs, v.limbs, self.spec)
        return ok, self._new(r)

    # -- observation --------------------------------------------------------
    def canonical(self) -> "FieldElement":
        return self._new(_l.canonical(self.limbs, self.spec))

    def to_bytes(self) -> torch.Tensor:
        """Canonical 32-byte little-endian encoding [..., 32] uint8."""
        return _l.to_bytes(self.limbs, self.spec)

    def eq(self, other: "FieldElement") -> torch.Tensor:
        return _l.eq(self.limbs, other.limbs, self.spec)

    def cmp(self, other: "FieldElement") -> torch.Tensor:
        """Three-way compare of the canonical values: -1 / 0 / +1 int32."""
        return _l.cmp(self.limbs, other.limbs, self.spec)

    def __lt__(self, other: "FieldElement") -> torch.Tensor:
        return self.cmp(other) < 0

    def __le__(self, other: "FieldElement") -> torch.Tensor:
        return self.cmp(other) <= 0

    def __gt__(self, other: "FieldElement") -> torch.Tensor:
        return self.cmp(other) > 0

    def __ge__(self, other: "FieldElement") -> torch.Tensor:
        return self.cmp(other) >= 0

    def is_zero(self) -> torch.Tensor:
        return _l.is_zero(self.limbs, self.spec)

    def is_positive(self) -> torch.Tensor:
        """Decaf non-negativity: canonical value <= (p-1)/2."""
        return _isq.is_positive(self.limbs, self.spec)

    def abs(self) -> "FieldElement":
        return self._new(_isq.abs_positive(self.limbs, self.spec))

    def is_even(self) -> torch.Tensor:
        return (_l.canonical(self.limbs, self.spec)[..., 0].to(torch.int32) & 1) == 0

    def conditional_negate(self, cond) -> "FieldElement":
        return self._new(_isq.conditional_negate(
            self.limbs, mask_like(cond, self.limbs).to(torch.bool)))

    def select(self, cond, other: "FieldElement") -> "FieldElement":
        """where(cond, self, other), limbwise."""
        return self._new(_l.select(mask_like(cond, self.limbs).to(torch.bool),
                                   self.limbs, other.limbs))

    def to_ints(self):
        """Canonical values as python ints (host pull; tests only)."""
        return ints_of_limbs(self.limbs, self.spec)

    def __repr__(self) -> str:
        return (f"FieldElement(shape={self.shape}, backend={self.spec.name}, "
                f"device={self.limbs.device})")


def ints_of_limbs(x: torch.Tensor, spec: ModSpec):
    """Canonical values of [..., nlimbs] limbs as a python int (one element)
    or an object array of them."""
    arr = _l.canonical(x, spec).to(torch.int64).cpu().numpy()
    flat = [oracle.limbs_to_int(row, w=spec.wbits)
            for row in arr.reshape(-1, spec.nlimbs)]
    return flat[0] if arr.ndim == 1 else np.array(
        flat, dtype=object).reshape(arr.shape[:-1])


# The JAX package's module constants, as i32x22 elements on the default
# device, built when first read.
_MODULE_CONSTANTS = ("EDWARDS_D", "EDWARDS_A", "SQRT_M1", "INV_SQRT_A",
                     "MINUS_SQRT_A", "INV_SQRT_A_MINUS_D", "SQRT_AD_MINUS_ONE",
                     "ONE_MINUS_D_SQ", "D_MINUS_ONE_SQ")


def __getattr__(name: str) -> FieldElement:
    if name in _MODULE_CONSTANTS:
        return FieldElement(_l.const(getattr(C, name + "_LIMBS"),
                                     _cfg.default_device()))
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
