"""Scalar recodings on the host (zerocaf_tpu/native.py counterpart): NAF,
width-w NAF, bits and unsigned windows of little-endian scalar bytes, and
the radix-2^12 limb codecs.  The JAX package loads a C++ library for these
when it is built and has ``available()`` to say so; the port has no native
library to load, so it has no ``available()``: this numpy is all of it.

Recoding is sequential in the bits of one scalar and parallel over scalars,
so each function is numpy over the batch axis: one pass per bit position,
no loop over scalars.  The digits feed ``models.edwards.binary_naf_mul``
and ``window_naf_mul``.  Inputs are [..., 32] uint8; outputs int8
[..., nbits] (``windows``: int32 [..., nwin]).
"""

from __future__ import annotations

import numpy as np


def _as_scalar_bytes(scalars_le) -> np.ndarray:
    b = np.ascontiguousarray(scalars_le, dtype=np.uint8)
    if b.ndim == 0 or b.shape[-1] != 32:
        raise ValueError(f"expected [..., 32] scalar bytes, got {b.shape}")
    return b.reshape(-1, 32)


def _check_naf_domain(b: np.ndarray, nbits: int) -> None:
    """NAF and wNAF can spill one digit past the MSB, so an input must
    satisfy k < 2^(nbits-1), or the fixed-length digit array would drop a
    digit.  Past 256 digits every 256-bit value fits, but the reference's
    engine rejects an all-ones top byte (its 256-bit add-back would wrap);
    this keeps the same domain."""
    if nbits > 256:
        if (b[:, 31] == 0xFF).any():
            raise ValueError("naf/wnaf: input scalar within 2^248 of 2^256 "
                             "overflows the 256-bit recoding engine")
        return
    bits8 = np.unpackbits(b, axis=-1, bitorder="little")
    if bits8[:, nbits - 1:].any():
        raise ValueError(
            f"naf/wnaf: input scalar >= 2^{nbits - 1}; recoding needs more "
            f"than nbits={nbits} digits")


def _bit_matrix(b: np.ndarray, ncols: int) -> np.ndarray:
    """[n, 32] bytes -> [n, ncols] LSB-first bits (int32), zero-padded."""
    bits8 = np.unpackbits(b, axis=-1, bitorder="little").astype(np.int32)
    if ncols > 256:
        bits8 = np.pad(bits8, [(0, 0), (0, ncols - 256)])
    return bits8[:, :ncols]


def _wnaf_digits(b: np.ndarray, width: int, nbits: int) -> np.ndarray:
    """Width-w NAF of each row, LSB first: at each bit position a lane whose
    last digit's window is not yet consumed emits 0; otherwise its window
    value is the next ``width`` bits plus the carry.  An odd window emits
    the signed residue mod 2^width (carrying 1 where it is negative) and
    consumes the window; an even one emits 0 and keeps the carry.  This is
    the reference's k -= d; k >>= 1 loop, digit for digit."""
    n = b.shape[0]
    bits = np.ascontiguousarray(_bit_matrix(b, nbits + width).T)  # [bit, n]
    win = np.zeros((nbits, n), np.int32)
    for j in range(width):
        win += bits[j:j + nbits] << j
    half, full = 1 << (width - 1), 1 << width
    out = np.zeros((nbits, n), np.int32)
    carry = np.zeros(n, np.int32)
    skip = np.zeros(n, np.int32)
    for i in range(nbits):
        w = win[i] + carry
        take = (skip == 0) & ((w & 1) == 1)
        neg = take & (w >= half)
        out[i] = np.where(take, w - (neg * full), 0)
        carry = np.where(take, neg, carry)
        skip = np.where(take, width - 1, skip - (skip > 0))
    return out.T.astype(np.int8)


def naf(scalars_le, nbits: int = 256) -> np.ndarray:
    """[..., 32] LE scalar bytes -> [..., nbits] int8 NAF digits."""
    b = _as_scalar_bytes(scalars_le)
    _check_naf_domain(b, nbits)
    return _wnaf_digits(b, 2, nbits).reshape(*np.shape(scalars_le)[:-1], nbits)


def wnaf(scalars_le, width: int, nbits: int = 256) -> np.ndarray:
    """[..., 32] LE scalar bytes -> [..., nbits] int8 width-w NAF digits:
    odd digits with |d| < 2^(width-1), any two nonzero digits at least
    ``width`` positions apart."""
    if not 2 <= width <= 8:
        raise ValueError(f"wnaf width must be in 2..8, got {width}")
    b = _as_scalar_bytes(scalars_le)
    _check_naf_domain(b, nbits)
    return _wnaf_digits(b, width, nbits).reshape(*np.shape(scalars_le)[:-1], nbits)


def bits(scalars_le, nbits: int = 256) -> np.ndarray:
    """[..., 32] LE scalar bytes -> [..., nbits] int8 LSB-first bits."""
    b = _as_scalar_bytes(scalars_le)
    out = _bit_matrix(b, nbits).astype(np.int8)
    return out.reshape(*np.shape(scalars_le)[:-1], nbits)


def windows(scalars_le, c: int, nwin: int) -> np.ndarray:
    """Pippenger digit decomposition: [..., nwin] int32, digit i = bits
    [i*c, (i+1)*c) of the scalar."""
    b = _as_scalar_bytes(scalars_le)
    groups = _bit_matrix(b, nwin * c).reshape(b.shape[0], nwin, c)
    out = (groups << np.arange(c, dtype=np.int32)).sum(-1).astype(np.int32)
    return out.reshape(*np.shape(scalars_le)[:-1], nwin)


def bytes_to_limbs(bytes_le) -> np.ndarray:
    """[..., 32] LE bytes -> [..., 22] int32 radix-2^12 limbs of the raw
    256-bit value (limb 21 holds bits 252..255).  Radix 2^12 is three
    nibbles: limb k = nib[3k] + 16 nib[3k+1] + 256 nib[3k+2]."""
    b = _as_scalar_bytes(bytes_le)
    nib = np.stack([b & 15, b >> 4], axis=-1).reshape(b.shape[0], 64)
    g = np.pad(nib, [(0, 0), (0, 2)]).reshape(b.shape[0], 22, 3).astype(np.int32)
    out = g[..., 0] | (g[..., 1] << 4) | (g[..., 2] << 8)
    return out.reshape(*np.shape(bytes_le)[:-1], 22)


def limbs_to_bytes(limbs) -> np.ndarray:
    """[..., 22] canonical int32 limbs -> [..., 32] uint8 LE: the low 12
    bits of each limb, bits past 255 dropped."""
    x = np.ascontiguousarray(limbs, dtype=np.int32).reshape(-1, 22) & 0xFFF
    nib = np.stack([x & 15, (x >> 4) & 15, x >> 8], axis=-1).reshape(-1, 66)[:, :64]
    out = (nib[:, 0::2] | (nib[:, 1::2] << 4)).astype(np.uint8)
    return out.reshape(*np.shape(limbs)[:-1], 32)
