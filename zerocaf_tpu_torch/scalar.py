"""Batched scalars mod r = 2^249 + 14490550575682688738086195780655237219
(zerocaf_tpu/scalar.py counterpart): the same limb engine under the scalar
modulus, plus the recodings that feed the scalar-multiplication kernels
(bits for the ladder, width-w windows for the windowed kernels, NAF and
wNAF digits on the host by ``recode``).  Constructors given no device use
``config.default_device()``.

On CUDA tensors products are the K1 kernel modulo r and the inverse the K2
chain r - 2 modulo r; a power by a per-lane exponent is
``limb.pow_batched``, two K1 launches a bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import constants as C
from . import oracle
from . import recode
from .field import (FieldElement, mask_like, ints_of_limbs, limbs_of_ints,
                    random_bytes, shift_right)
from .ops import limb as _l
from .ops.limb import SCALAR as _S


@dataclasses.dataclass(frozen=True)
class Scalar:
    limbs: torch.Tensor  # [..., 22] int32
    SPEC = _S            # the modulus (a class constant, not a field)

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_int(cls, v, device=None) -> "Scalar":
        """Python int(s) mod r; a sequence gives a batch."""
        return cls(limbs_of_ints(v, oracle.R, device))

    @classmethod
    def zero(cls, device=None) -> "Scalar":
        return cls.from_int(0, device)

    @classmethod
    def one(cls, device=None) -> "Scalar":
        return cls.from_int(1, device)

    @classmethod
    def minus_one(cls, device=None) -> "Scalar":
        return cls.from_int(C.R - 1, device)

    @classmethod
    def two_pow_k(cls, k: int, device=None) -> "Scalar":
        """2^k for 0 <= k < 250."""
        if not 0 <= k < 250:
            raise ValueError(f"two_pow_k needs 0 <= k < 250, got {k}")
        return cls.from_int(1 << k, device)

    @classmethod
    def from_bytes(cls, b: torch.Tensor) -> tuple["Scalar", torch.Tensor]:
        """[..., 32] uint8 LE -> (scalars, canonical mask).  The value is
        reduced mod r either way; the mask is False where re-encoding does
        not give the input bytes back (a value >= r)."""
        v = _l.from_bytes(b, _S)
        return cls(v), torch.all(_l.to_bytes(v, _S) == b, dim=-1)

    @classmethod
    def from_bytes_wide(cls, b: torch.Tensor) -> "Scalar":
        """[..., 64] uint8 -> the 512-bit value mod r."""
        lo = _l.from_bytes(b[..., :32], _S)
        hi = _l.from_bytes(b[..., 32:], _S)
        shift = _l.const(_SHIFT_256, b.device)
        return cls(_l.add(_l.mul(hi, shift, _S), lo))

    @classmethod
    def random(cls, generator: torch.Generator, shape: tuple[int, ...] = (),
               device=None) -> "Scalar":
        """Uniform scalars: wide reduction of 64 random bytes drawn from
        ``generator`` (on the generator's device), placed on ``device``
        (None: the default device)."""
        return cls.from_bytes_wide(random_bytes(generator, shape, 64, device))

    # -- shape plumbing -----------------------------------------------------
    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.limbs.shape[:-1])

    def __getitem__(self, idx) -> "Scalar":
        return Scalar(self.limbs[idx])

    def broadcast_to(self, shape) -> "Scalar":
        return Scalar(self.limbs.expand(*tuple(shape), _l.L))

    # -- ring ops -----------------------------------------------------------
    def __add__(self, other: "Scalar") -> "Scalar":
        return Scalar(_l.add(self.limbs, other.limbs))

    def __sub__(self, other: "Scalar") -> "Scalar":
        return Scalar(_l.sub(self.limbs, other.limbs))

    def __neg__(self) -> "Scalar":
        return Scalar(_l.neg(self.limbs))

    def __mul__(self, other: "Scalar") -> "Scalar":
        return Scalar(_l.mul(self.limbs, other.limbs, _S))

    def square(self) -> "Scalar":
        return Scalar(_l.square(self.limbs, _S))

    def half(self) -> "Scalar":
        """x / 2 mod r."""
        return Scalar(_l.mul(self.limbs, _l.const(_HALF, self.limbs.device), _S))

    def inverse(self) -> "Scalar":
        """Fermat a^(r-2) (K2 modulo r on CUDA); zero maps to zero."""
        return Scalar(_l.pow_const(self.limbs, C.EXP_SINV, _S))

    def pow(self, exp) -> "Scalar":
        """a^e: a python-int exponent runs a fixed chain; a Scalar exponent
        a 250-step ladder over its canonical bits (``limb.pow_batched``)."""
        if isinstance(exp, int):
            return Scalar(_l.pow_const(self.limbs, exp, _S))
        bits = _l.to_bits(exp.limbs, exp.SPEC, 250)
        return Scalar(_l.pow_batched(self.limbs, bits, _S))

    # -- observation --------------------------------------------------------
    def canonical(self) -> "Scalar":
        return Scalar(_l.canonical(self.limbs, _S))

    def to_bytes(self) -> torch.Tensor:
        return _l.to_bytes(self.limbs, _S)

    def eq(self, other: "Scalar") -> torch.Tensor:
        return _l.eq(self.limbs, other.limbs, _S)

    def cmp(self, other: "Scalar") -> torch.Tensor:
        """Three-way compare of the canonical values: -1 / 0 / +1 int32."""
        return _l.cmp(self.limbs, other.limbs, _S)

    def __lt__(self, other: "Scalar") -> torch.Tensor:
        return self.cmp(other) < 0

    def __le__(self, other: "Scalar") -> torch.Tensor:
        return self.cmp(other) <= 0

    def __gt__(self, other: "Scalar") -> torch.Tensor:
        return self.cmp(other) > 0

    def __ge__(self, other: "Scalar") -> torch.Tensor:
        return self.cmp(other) >= 0

    def is_zero(self) -> torch.Tensor:
        return _l.is_zero(self.limbs, _S)

    def is_even(self) -> torch.Tensor:
        return (_l.canonical(self.limbs, _S)[..., 0] & 1) == 0

    def select(self, cond, other: "Scalar") -> "Scalar":
        """where(cond, self, other), limbwise."""
        return Scalar(_l.select(mask_like(cond, self.limbs).to(torch.bool),
                                self.limbs, other.limbs))

    def __rshift__(self, k: int) -> "Scalar":
        """Logical right shift of the canonical value."""
        return Scalar(shift_right(self.limbs, _S, k, 250))

    def half_without_mod(self) -> "Scalar":
        """Exact halving of an even scalar: the value shifted right by 1."""
        return self >> 1

    def mod_2_pow_k(self, k: int) -> torch.Tensor:
        """The canonical value mod 2^k, 0 < k <= 12, int32."""
        if not 0 < k <= _l.W:
            raise ValueError(f"mod_2_pow_k needs 0 < k <= {_l.W}, got {k}")
        return _l.canonical(self.limbs, _S)[..., 0] & ((1 << k) - 1)

    def mods_2_pow_k(self, w: int) -> torch.Tensor:
        """The signed residue in [-2^(w-1), 2^(w-1)), 0 < w <= 12, int32."""
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
        return _l.to_bits(self.limbs, _S, nbits)

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
        lc = _l.canonical(self.limbs, _S)
        mask = (1 << width) - 1
        outs = []
        for i in range(nwin):
            base = i * width
            d = torch.zeros_like(lc[..., 0])
            for j in range(base // _l.W, min((base + width - 1) // _l.W + 1, _l.L)):
                sh = _l.W * j - base
                v = lc[..., j]
                d = d | ((v << sh) if sh >= 0 else (v >> -sh))
            outs.append(d & mask)
        return torch.stack(outs, dim=-1)

    def to_ints(self):
        """Canonical values as python ints (host pull; tests only)."""
        return ints_of_limbs(self.limbs, _S)

    def __repr__(self) -> str:
        return f"Scalar(shape={self.shape}, device={self.limbs.device})"


_SHIFT_256 = _l.int_limbs(pow(2, 256, oracle.R))
_HALF = _l.int_limbs(C.SCALAR_INVERSE_MOD_TWO)

# The ristretto255 scalar ring (integers mod the ed25519 group order) is
# this curve's base field, so the reference's alias names FieldElement.
Ristretto255Scalar = FieldElement
