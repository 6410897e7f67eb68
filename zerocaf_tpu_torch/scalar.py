"""Batched scalars mod r = 2^249 + 14490550575682688738086195780655237219
(zerocaf_tpu/scalar.py counterpart): the same limb engine under the scalar
modulus, plus the recodings that feed the scalar-multiplication kernels
(bits for the ladder, width-w windows for the windowed kernels)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import oracle
from .ops import limb as _l
from .ops.limb import SCALAR as _S


@dataclasses.dataclass(frozen=True)
class Scalar:
    limbs: torch.Tensor  # [..., 22] int32

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_int(cls, v, device=None) -> "Scalar":
        """Python int(s) mod r; a sequence gives a batch."""
        vals = np.ravel(np.asarray(v, dtype=object))
        arr = np.stack([_l.int_limbs(int(x) % oracle.R) for x in vals])
        arr = arr.reshape(*np.shape(v), _l.L)
        return cls(torch.as_tensor(arr, device=device))

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
        ``generator`` (on the generator's device), placed on ``device``."""
        raw = torch.randint(0, 256, tuple(shape) + (64,), generator=generator,
                            dtype=torch.uint8, device=generator.device)
        return cls.from_bytes_wide(raw.to(device))

    # -- shape plumbing -----------------------------------------------------
    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.limbs.shape[:-1])

    def __getitem__(self, idx) -> "Scalar":
        return Scalar(self.limbs[idx])

    # -- observation --------------------------------------------------------
    def canonical(self) -> "Scalar":
        return Scalar(_l.canonical(self.limbs, _S))

    def to_bytes(self) -> torch.Tensor:
        return _l.to_bytes(self.limbs, _S)

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
        arr = _l.canonical(self.limbs, _S).cpu().numpy()
        flat = [oracle.limbs_to_int(row) for row in arr.reshape(-1, _l.L)]
        return flat[0] if arr.ndim == 1 else np.array(
            flat, dtype=object).reshape(arr.shape[:-1])


_SHIFT_256 = _l.int_limbs(pow(2, 256, oracle.R))
