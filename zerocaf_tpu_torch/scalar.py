"""Batched scalars mod r = 2^249 + 14490550575682688738086195780655237219
(zerocaf_tpu/scalar.py counterpart): the same limb engine under the scalar
modulus, plus the recodings that feed the scalar-multiplication kernels
(bits for the ladder, width-w windows for the windowed kernels, NAF and
wNAF digits on the host by ``recode``).  Constructors given no device use
``config.default_device()``; given no ``spec``, the active backend's
(``config.get_backend()``): int32 [..., 22] limbs on i32x22, float32
[..., 29] on f32x29.

On CUDA tensors the i32x22 products are the K1 kernel modulo r and the
inverse the K2 chain r - 2 modulo r; a power by a per-lane exponent is
``limb.pow_batched``, two K1 launches a bit.  The f32x29 backend is plain
PyTorch on every device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import config as _cfg
from . import constants as C
from . import recode
from .field import (FieldElement, mask_like, ints_of_limbs, limbs_of_ints,
                    random_bytes, shift_right)
from .ops import limb as _l
from .ops.limb import SCALAR as _S
from .ops.limb import ModSpec


def _scalar_spec(spec: ModSpec | None) -> ModSpec:
    """``spec``, or the active backend's scalar spec for None."""
    return spec if spec is not None else _l.BACKENDS[_cfg.get_backend()][1]


@dataclasses.dataclass(frozen=True)
class Scalar:
    limbs: torch.Tensor  # [..., spec.nlimbs] of spec.dtype
    spec: ModSpec = _S   # the limb backend (i32x22 unless given)

    def _new(self, limbs: torch.Tensor) -> "Scalar":
        return Scalar(limbs, self.spec)

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_int(cls, v, device=None, spec: ModSpec | None = None) -> "Scalar":
        """Python int(s) mod r; a sequence gives a batch."""
        s = _scalar_spec(spec)
        return cls(limbs_of_ints(v, s, device), s)

    @classmethod
    def zero(cls, device=None, spec: ModSpec | None = None) -> "Scalar":
        return cls.from_int(0, device, spec)

    @classmethod
    def one(cls, device=None, spec: ModSpec | None = None) -> "Scalar":
        return cls.from_int(1, device, spec)

    @classmethod
    def minus_one(cls, device=None, spec: ModSpec | None = None) -> "Scalar":
        return cls.from_int(C.R - 1, device, spec)

    @classmethod
    def two_pow_k(cls, k: int, device=None, spec: ModSpec | None = None) -> "Scalar":
        """2^k for 0 <= k < 250."""
        if not 0 <= k < 250:
            raise ValueError(f"two_pow_k needs 0 <= k < 250, got {k}")
        return cls.from_int(1 << k, device, spec)

    @classmethod
    def from_bytes(cls, b: torch.Tensor,
                   spec: ModSpec | None = None) -> tuple["Scalar", torch.Tensor]:
        """[..., 32] uint8 LE -> (scalars, canonical mask).  The value is
        reduced mod r either way; the mask is False where re-encoding does
        not give the input bytes back (a value >= r)."""
        s = _scalar_spec(spec)
        v = _l.from_bytes(b, s)
        return cls(v, s), torch.all(_l.to_bytes(v, s) == b, dim=-1)

    @classmethod
    def from_bytes_wide(cls, b: torch.Tensor, spec: ModSpec | None = None) -> "Scalar":
        """[..., 64] uint8 -> the 512-bit value mod r."""
        s = _scalar_spec(spec)
        lo = _l.from_bytes(b[..., :32], s)
        hi = _l.from_bytes(b[..., 32:], s)
        shift = _l.const_int(pow(2, 256, C.R), s, b.device)
        return cls(_l.add(_l.mul(hi, shift, s), lo), s)

    @classmethod
    def random(cls, generator: torch.Generator, shape: tuple[int, ...] = (),
               device=None, spec: ModSpec | None = None) -> "Scalar":
        """Uniform scalars: wide reduction of 64 random bytes drawn from
        ``generator`` (on the generator's device), placed on ``device``
        (None: the default device)."""
        return cls.from_bytes_wide(random_bytes(generator, shape, 64, device), spec)

    # -- shape plumbing -----------------------------------------------------
    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.limbs.shape[:-1])

    def __getitem__(self, idx) -> "Scalar":
        return self._new(self.limbs[idx])

    def broadcast_to(self, shape) -> "Scalar":
        return self._new(self.limbs.expand(*tuple(shape), self.spec.nlimbs))

    # -- ring ops -----------------------------------------------------------
    def __add__(self, other: "Scalar") -> "Scalar":
        return self._new(_l.add(self.limbs, other.limbs))

    def __sub__(self, other: "Scalar") -> "Scalar":
        return self._new(_l.sub(self.limbs, other.limbs))

    def __neg__(self) -> "Scalar":
        return self._new(_l.neg(self.limbs))

    def __mul__(self, other: "Scalar") -> "Scalar":
        return self._new(_l.mul(self.limbs, other.limbs, self.spec))

    def square(self) -> "Scalar":
        return self._new(_l.square(self.limbs, self.spec))

    def half(self) -> "Scalar":
        """x / 2 mod r."""
        half = _l.const_int(C.SCALAR_INVERSE_MOD_TWO, self.spec, self.limbs.device)
        return self._new(_l.mul(self.limbs, half, self.spec))

    def inverse(self) -> "Scalar":
        """Fermat a^(r-2) (K2 modulo r on CUDA for i32x22); zero maps to
        zero."""
        return self._new(_l.pow_const(self.limbs, C.EXP_SINV, self.spec))

    def pow(self, exp) -> "Scalar":
        """a^e: a python-int exponent runs a fixed chain; a Scalar exponent
        a 250-step ladder over its canonical bits (``limb.pow_batched``)."""
        if isinstance(exp, int):
            return self._new(_l.pow_const(self.limbs, exp, self.spec))
        bits = _l.to_bits(exp.limbs, exp.spec, 250)
        return self._new(_l.pow_batched(self.limbs, bits, self.spec))

    # -- observation --------------------------------------------------------
    def canonical(self) -> "Scalar":
        return self._new(_l.canonical(self.limbs, self.spec))

    def to_bytes(self) -> torch.Tensor:
        return _l.to_bytes(self.limbs, self.spec)

    def eq(self, other: "Scalar") -> torch.Tensor:
        return _l.eq(self.limbs, other.limbs, self.spec)

    def cmp(self, other: "Scalar") -> torch.Tensor:
        """Three-way compare of the canonical values: -1 / 0 / +1 int32."""
        return _l.cmp(self.limbs, other.limbs, self.spec)

    def __lt__(self, other: "Scalar") -> torch.Tensor:
        return self.cmp(other) < 0

    def __le__(self, other: "Scalar") -> torch.Tensor:
        return self.cmp(other) <= 0

    def __gt__(self, other: "Scalar") -> torch.Tensor:
        return self.cmp(other) > 0

    def __ge__(self, other: "Scalar") -> torch.Tensor:
        return self.cmp(other) >= 0

    def is_zero(self) -> torch.Tensor:
        return _l.is_zero(self.limbs, self.spec)

    def is_even(self) -> torch.Tensor:
        return (self._canonical_int()[..., 0] & 1) == 0

    def _canonical_int(self) -> torch.Tensor:
        """The canonical limbs as int32, whatever the backend."""
        return _l.canonical(self.limbs, self.spec).to(torch.int32)

    def select(self, cond, other: "Scalar") -> "Scalar":
        """where(cond, self, other), limbwise."""
        return self._new(_l.select(mask_like(cond, self.limbs).to(torch.bool),
                                   self.limbs, other.limbs))

    def __rshift__(self, k: int) -> "Scalar":
        """Logical right shift of the canonical value."""
        return self._new(shift_right(self.limbs, self.spec, k, 250))

    def half_without_mod(self) -> "Scalar":
        """Exact halving of an even scalar: the value shifted right by 1."""
        return self >> 1

    def mod_2_pow_k(self, k: int) -> torch.Tensor:
        """The canonical value mod 2^k, 0 < k <= the radix bits (12, or 9
        on f32x29), int32."""
        if not 0 < k <= self.spec.wbits:
            raise ValueError(f"mod_2_pow_k needs 0 < k <= {self.spec.wbits}, "
                             f"got {k}")
        return self._canonical_int()[..., 0] & ((1 << k) - 1)

    def mods_2_pow_k(self, w: int) -> torch.Tensor:
        """The signed residue in [-2^(w-1), 2^(w-1)), 0 < w <= the radix
        bits, int32."""
        m = self.mod_2_pow_k(w)
        return torch.where(m >= (1 << (w - 1)), m - (1 << w), m)

    def compute_naf(self, nbits: int = 256) -> np.ndarray:
        """NAF digits [..., nbits] int8 on the host (``recode.naf``)."""
        return recode.naf(self.to_bytes().cpu().numpy(), nbits)

    def compute_window_naf(self, width: int, nbits: int = 256) -> np.ndarray:
        """Width-w NAF digits [..., nbits] int8 on the host (``recode.wnaf``)."""
        return recode.wnaf(self.to_bytes().cpu().numpy(), width, nbits)

    def into_bits(self, nbits: int = 250) -> torch.Tensor:
        """LSB-first bits [..., nbits] int32; 250 bits cover every canonical
        scalar (r < 2^250)."""
        return _l.to_bits(self.limbs, self.spec, nbits)

    def windows(self, width: int, nwin: int | None = None) -> torch.Tensor:
        """Unsigned width-bit windows [..., nwin] int32, digit i = bits
        [i*w, (i+1)*w), read straight from the canonical limbs with static
        shifts (a window of width <= 19 straddles limbs without overflow).
        Wider windows sum their bits (``into_bits``), as the JAX package
        does; past width 31 a window no longer fits int32."""
        if not 1 <= width <= 31:
            raise ValueError(f"window width must be in 1..31, got {width}")
        if nwin is None:
            nwin = -(-250 // width)
        if width > 19:
            bits = self.into_bits(nwin * width)
            groups = bits.reshape(*bits.shape[:-1], nwin, width)
            weights = torch.tensor([1 << i for i in range(width)],
                                   dtype=torch.int64, device=bits.device)
            return (groups.long() * weights).sum(-1).to(torch.int32)
        lc = self._canonical_int()
        wb, nl = self.spec.wbits, self.spec.nlimbs
        mask = (1 << width) - 1
        outs = []
        for i in range(nwin):
            base = i * width
            d = torch.zeros_like(lc[..., 0])
            for j in range(base // wb, min((base + width - 1) // wb + 1, nl)):
                sh = wb * j - base
                v = lc[..., j]
                d = d | ((v << sh) if sh >= 0 else (v >> -sh))
            outs.append(d & mask)
        return torch.stack(outs, dim=-1)

    def to_ints(self):
        """Canonical values as python ints (host pull; tests only)."""
        return ints_of_limbs(self.limbs, self.spec)

    def __repr__(self) -> str:
        return (f"Scalar(shape={self.shape}, backend={self.spec.name}, "
                f"device={self.limbs.device})")


# The ristretto255 scalar ring (integers mod the ed25519 group order) is
# this curve's base field, so the reference's alias names FieldElement.
Ristretto255Scalar = FieldElement
