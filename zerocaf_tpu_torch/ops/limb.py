"""Multi-precision limb engine: radix-2^12 x 22-limb int32 arithmetic
(zerocaf_tpu/ops/limb.py counterpart).

Elements flow between operations in *semi-reduced* form (22 limbs, non-top
limbs near [0, 4096), |value| < 2^253) and are canonicalized only where they
are observed: bytes, comparisons, bits.  Both moduli are pseudo-Mersenne,
p = 2^252 + dp and r = 2^249 + dr, so a product folds at limb 21 with
2^252 == -c (mod m), c < 2^133.

Reduction is the all-VPU cascade of the JAX package (43 columns -> carry 44 ->
fold 35 -> fold 26 -> fold 22).  The JAX package's default int8-MXU fold was a
TPU device choice; it is value-identical to the cascade, so the port's limbs
can differ from the JAX package's and only canonical values are compared.

Every function works on int32 tensors with the limb axis last and broadcasts
over leading batch axes.  ``>>`` on int32 is an arithmetic shift and ``&`` is
two's complement, which the carry algebra relies on for negative limbs.
``mul``, ``square`` and ``pow_const`` (for exponents of 32 bits or more) go
through the kernel wrappers of ``ops/kernels/field_kernels.py``: a CUDA
kernel for CUDA tensors, the same algebra in plain PyTorch for CPU tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .. import constants as C
from .. import oracle
from ..config import FOLD_LIMB, LIMB_MASK, NUM_LIMBS, RADIX_BITS

MASK = LIMB_MASK
W = RADIX_BITS
L = NUM_LIMBS


def int_limbs(v: int) -> np.ndarray:
    """A non-negative int below 2^264 as [22] int32 limbs."""
    return np.array(oracle.int_to_limbs(v, n=L), dtype=np.int32)


@dataclasses.dataclass(frozen=True, eq=False)
class ModSpec:
    """A pseudo-Mersenne modulus m with 2^252 == -fold_c (mod m).

    ``kernel_id`` selects the row of the CUDA kernels' fold-constant table.
    For the scalar field r = 2^249 + dr the canonical range is below 2^249:
    ``final_fold_bits`` / ``final_c_limbs`` describe the last fold of
    ``canonical``."""

    name: str
    kernel_id: int
    m: int
    m_limbs: np.ndarray
    fold_c_limbs: np.ndarray
    final_fold_bits: int
    final_c_limbs: np.ndarray

    @property
    def m64_limbs(self) -> np.ndarray:
        return _M64[self.name]


FIELD = ModSpec("field", 0, C.P, C.P_LIMBS, C.FOLD_C_P_LIMBS,
                final_fold_bits=252, final_c_limbs=C.FOLD_C_P_LIMBS)
SCALAR = ModSpec("scalar", 1, C.R, C.R_LIMBS, C.FOLD_C_R_LIMBS,
                 final_fold_bits=249, final_c_limbs=C.DELTA_R_LIMBS)
# 64*m > 2^255 for both moduli: canonical() adds it to negative values
_M64 = {s.name: int_limbs(s.m << 6) for s in (FIELD, SCALAR)}

# Host constants moved to a device once; keyed by the id of a module-level
# array, whose reference the cache keeps so that the id stays unique.
_DEVICE_CONSTS: dict = {}


def const(arr: np.ndarray, device) -> torch.Tensor:
    """A module-level numpy constant as an int32 tensor on ``device``."""
    device = torch.device("cpu" if device is None else device)
    key = (id(arr), device)
    hit = _DEVICE_CONSTS.get(key)
    if hit is None:
        hit = _DEVICE_CONSTS[key] = (arr, torch.as_tensor(arr, device=device))
    return hit[1]


def _pad(x: torch.Tensor, hi: int, lo: int = 0) -> torch.Tensor:
    """Zero-pad the limb axis: ``lo`` limbs below, ``hi`` above."""
    return F.pad(x, (lo, hi)) if (lo or hi) else x


# ---------------------------------------------------------------------------
# Carry propagation
# ---------------------------------------------------------------------------


def carry_keep_top(x: torch.Tensor, extra: int = 1,
                   passes: int = 2) -> torch.Tensor:
    """Data-parallel carry passes.  Pads ``extra`` zero limbs; each pass
    splits limbs 0..n-2 into (x & mask, x >> 12) and adds the carry one limb
    up.  The top limb accumulates raw: it carries the sign of a negative
    value.  After two passes the non-top limbs are in [-13, 4096+13]."""
    x = _pad(x, extra)
    keep = _keep_mask(x.shape[-1], x.device)
    for _ in range(passes):
        x = (x & keep) + _pad((x >> W)[..., :-1], 0, lo=1)
    return x


_KEEP_MASKS: dict = {}


def _keep_mask(n: int, device) -> torch.Tensor:
    """[4095] * (n-1) + [-1]: ``x & mask`` keeps the top limb whole."""
    key = (n, device)
    m = _KEEP_MASKS.get(key)
    if m is None:
        m = torch.full((n,), MASK, dtype=torch.int32, device=device)
        m[-1] = -1
        _KEEP_MASKS[key] = m
    return m


def carry_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact sequential carry: limbs 0..n-2 land in [0, 4096) and the top
    limb keeps the remaining signed value.  Observation boundaries only."""
    cols = x.unbind(-1)
    c = torch.zeros_like(cols[0])
    out = []
    for xi in cols[:-1]:
        t = xi + c
        out.append(t & MASK)
        c = t >> W
    out.append(cols[-1] + c)
    return torch.stack(out, dim=-1)


# ---------------------------------------------------------------------------
# Schoolbook products
# ---------------------------------------------------------------------------


def _skew_sum(outer: torch.Tensor) -> torch.Tensor:
    """Sum the anti-diagonals of [..., na, nb]: out[k] = sum_{i+j=k}.  Row i
    is shifted right by i by padding rows to na + nb and re-reading the flat
    buffer with rows of na + nb - 1."""
    na, nb = outer.shape[-2:]
    ncols = na + nb - 1
    batch = outer.shape[:-2]
    flat = _pad(outer, na).reshape(*batch, na * (na + nb))
    return flat[..., : na * ncols].reshape(*batch, na, ncols).sum(
        dim=-2, dtype=torch.int32)


def school(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full schoolbook columns out[k] = sum_{i+j=k} a_i b_j:
    [..., na] x [..., nb] -> [..., na+nb-1], exact inside int32."""
    return _skew_sum(a[..., :, None] * b[..., None, :])


_SQ_WEIGHTS: dict = {}


def school_square(a: torch.Tensor) -> torch.Tensor:
    """Squaring columns in the symmetric form of the kernels (a_i * 2a_j
    above the diagonal, a_i^2 on it).  The columns are the same integers as
    school(a, a)."""
    n = a.shape[-1]
    key = (n, a.device)
    wts = _SQ_WEIGHTS.get(key)
    if wts is None:
        tri = np.triu(np.full((n, n), 2, np.int32), 1) + np.eye(n, dtype=np.int32)
        wts = _SQ_WEIGHTS[key] = torch.as_tensor(tri, device=a.device)
    return _skew_sum(a[..., :, None] * (a[..., None, :] * wts))


# ---------------------------------------------------------------------------
# Pseudo-Mersenne reduction
# ---------------------------------------------------------------------------


def _fold(x: torch.Tensor, spec: ModSpec) -> torch.Tensor:
    """One fold at limb 21: value(L) - c * value(H) (mod m), where
    L = x[:21] and H = x[21:].  Width n -> max(21, n - 10) + 1."""
    lo = x[..., :FOLD_LIMB]
    d = school(x[..., FOLD_LIMB:], const(spec.fold_c_limbs, x.device))
    ncols = max(FOLD_LIMB, d.shape[-1])
    y = _pad(lo, ncols - FOLD_LIMB) - _pad(d, ncols - d.shape[-1])
    return carry_keep_top(y)


def reduce_to_semi_cascade(cols: torch.Tensor, spec: ModSpec,
                           micro_fold: bool = False) -> torch.Tensor:
    """Product columns -> semi-reduced 22 limbs, |value| < 2^253.

    Width walk of a full product: 43 -> carry 44 -> fold 35 -> fold 26 ->
    fold 22.  ``micro_fold`` also folds the bits >= 252 still in the top
    limb, for inputs whose VALUE may reach 2^264 (raw byte decodes)."""
    x = carry_keep_top(cols)
    while x.shape[-1] > L:
        x = _fold(x, spec)
    x = _pad(x, L - x.shape[-1])
    if micro_fold:
        d = school(x[..., FOLD_LIMB:], const(spec.fold_c_limbs, x.device))
        z = _pad(x[..., :FOLD_LIMB], L - FOLD_LIMB)
        z = z - _pad(d, L - d.shape[-1])
        x = carry_keep_top(z, extra=0)
    return x


# ---------------------------------------------------------------------------
# Semi-reduced ring ops
# ---------------------------------------------------------------------------


def mul(a: torch.Tensor, b: torch.Tensor, spec: ModSpec) -> torch.Tensor:
    """a * b (mod m), semi-reduced in and out (one add deep allowed).  Runs
    the K1 kernel on CUDA tensors."""
    from .kernels import field_kernels as fk

    a, b = torch.broadcast_tensors(a, b)
    return fk.mul_tiled(a.contiguous(), b.contiguous(), spec)


def square(a: torch.Tensor, spec: ModSpec) -> torch.Tensor:
    """a^2 (mod m); the operand must be semi-reduced."""
    a = a.contiguous()
    return mul(a, a, spec)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b, lazy: one carry pass restores the limb slack and the next
    multiply's fold absorbs the extra value bit."""
    return carry_keep_top(a + b, extra=0, passes=1)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return carry_keep_top(a - b, extra=0, passes=1)


def neg(a: torch.Tensor) -> torch.Tensor:
    return carry_keep_top(-a, extra=0, passes=1)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Branch-free limbwise select; ``mask`` has no limb axis."""
    return torch.where(mask[..., None], a, b)


# ---------------------------------------------------------------------------
# Canonicalization and observation
# ---------------------------------------------------------------------------


def canonical(x: torch.Tensor, spec: ModSpec) -> torch.Tensor:
    """Semi-reduced -> canonical [0, m) with exact limbs in [0, 4096).
    Accepts any 22-limb value in (-2^255, 2^255):
      1. exact carry; if negative, add 64*m (> 2^255);
      2. fold the bits above 2^k (k = 252 for p, 249 for r):
         low + h*2^k == low - h*c (mod m), h < 2^10;
      3. the result is in (-m, m): one conditional add of m."""
    dev = x.device
    x = carry_exact(x)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    x = x + torch.where((x[..., -1] < 0)[..., None],
                        const(spec.m64_limbs, dev), zero)
    x = carry_exact(x)  # non-negative, < 2^259

    limb_i, bit_i = divmod(spec.final_fold_bits, W)
    if bit_i == 0:
        h = x[..., limb_i]
        lo = _pad(x[..., :limb_i], L - limb_i)
    else:
        h = (x[..., limb_i] >> bit_i) + (x[..., limb_i + 1] << (W - bit_i))
        low_bits = (x[..., limb_i] & ((1 << bit_i) - 1))[..., None]
        lo = _pad(torch.cat([x[..., :limb_i], low_bits], dim=-1),
                  L - limb_i - 1)
    d = school(h[..., None], const(spec.final_c_limbs, dev))
    y = carry_exact(lo - _pad(d, L - d.shape[-1]))
    y = y + torch.where((y[..., -1] < 0)[..., None],
                        const(spec.m_limbs, dev), zero)
    return carry_exact(y)


def eq(a: torch.Tensor, b: torch.Tensor, spec: ModSpec) -> torch.Tensor:
    """Canonical equality mask."""
    return torch.all(canonical(a, spec) == canonical(b, spec), dim=-1)


def is_zero(a: torch.Tensor, spec: ModSpec) -> torch.Tensor:
    return torch.all(canonical(a, spec) == 0, dim=-1)


def geq_const(x_canonical: torch.Tensor, bound_limbs: np.ndarray) -> torch.Tensor:
    """x >= bound for canonical x: branch-free lexicographic compare from
    the most significant limb; equal counts as >=."""
    b = const(bound_limbs, x_canonical.device)
    gt = x_canonical > b
    lt = x_canonical < b
    result = torch.zeros(x_canonical.shape[:-1], dtype=torch.bool,
                         device=x_canonical.device)
    decided = torch.zeros_like(result)
    for i in reversed(range(x_canonical.shape[-1])):
        result = result | (~decided & gt[..., i])
        decided = decided | gt[..., i] | lt[..., i]
    return result | ~decided


_LIMB_WEIGHTS: dict = {}


def cmp(a: torch.Tensor, b: torch.Tensor, spec: ModSpec) -> torch.Tensor:
    """Three-way compare of the canonical values: -1 / 0 / +1 int32 per
    lane.  The most significant differing limb decides: limb i's sign is
    weighted by 2^i, which outweighs every lower limb's together."""
    ca = canonical(a, spec)
    cb = canonical(b, spec)
    key = (ca.shape[-1], ca.device)
    w = _LIMB_WEIGHTS.get(key)
    if w is None:
        w = _LIMB_WEIGHTS[key] = 1 << torch.arange(ca.shape[-1], dtype=torch.int32,
                                                   device=ca.device)
    return torch.sign((torch.sign(ca - cb) * w).sum(-1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# Byte codecs (canonical little-endian 32 bytes)
# ---------------------------------------------------------------------------


def bytes_to_limbs(b: torch.Tensor) -> torch.Tensor:
    """[..., 32] uint8 -> [..., 22] int32 holding the raw 256-bit value.
    Radix 2^12 is three nibbles: limb k = nib[3k] + 16 nib[3k+1] +
    256 nib[3k+2]."""
    bi = b.to(torch.int32)
    nib = torch.stack([bi & 15, bi >> 4], dim=-1).reshape(*b.shape[:-1], 64)
    g = _pad(nib, 3 * L - 64).reshape(*b.shape[:-1], L, 3)
    return g[..., 0] + (g[..., 1] << 4) + (g[..., 2] << 8)


def limbs_to_bytes(x: torch.Tensor) -> torch.Tensor:
    """[..., 22] canonical limbs -> [..., 32] uint8 little-endian."""
    nib = torch.stack([x & 15, (x >> 4) & 15, x >> 8], dim=-1)
    g = nib.reshape(*x.shape[:-1], 3 * L)[..., :64].reshape(*x.shape[:-1], 32, 2)
    return (g[..., 0] + (g[..., 1] << 4)).to(torch.uint8)


def from_bytes(b: torch.Tensor, spec: ModSpec) -> torch.Tensor:
    """Decode 32 LE bytes to a semi-reduced element (the raw 256-bit value
    reduced mod m)."""
    return reduce_to_semi_cascade(bytes_to_limbs(b), spec, micro_fold=True)


def to_bytes(x: torch.Tensor, spec: ModSpec) -> torch.Tensor:
    return limbs_to_bytes(canonical(x, spec))


# ---------------------------------------------------------------------------
# Bits and small-int embedding
# ---------------------------------------------------------------------------


def to_bits(x: torch.Tensor, spec: ModSpec, nbits: int = 256) -> torch.Tensor:
    """Canonical LSB-first bits [..., nbits] int32."""
    xc = canonical(x, spec)
    shifts = torch.arange(W, dtype=torch.int32, device=x.device)
    bits = ((xc[..., None] >> shifts) & 1).reshape(*x.shape[:-1], L * W)
    return _pad(bits, max(0, nbits - L * W))[..., :nbits].contiguous()


def from_int(v: int, spec: ModSpec, device=None) -> torch.Tensor:
    """A python int as a canonical [22] limb tensor."""
    return torch.as_tensor(int_limbs(v % spec.m), device=device)


def one_like(x: torch.Tensor) -> torch.Tensor:
    """The element 1 with the shape, dtype and device of ``x``."""
    out = torch.zeros_like(x)
    out[..., 0] = 1
    return out


# ---------------------------------------------------------------------------
# Fixed-exponent powering
# ---------------------------------------------------------------------------


def pow_const(a: torch.Tensor, e: int, spec: ModSpec) -> torch.Tensor:
    """a^e for a python-int exponent.  Exponents of 32 bits or more (every
    inverse, square-root and Legendre chain) run the K2 windowed chain;
    shorter ones a plain MSB-first square-and-multiply."""
    from .kernels import field_kernels as fk

    if e < 0:
        raise ValueError(f"negative exponent {e}")
    if e.bit_length() >= 32:
        return fk.pow_tiled(a.contiguous(), e, spec)
    res = one_like(a)
    for bit in bin(e)[2:] if e else ():
        res = square(res, spec)
        if bit == "1":
            res = mul(res, a, spec)
    return res


def pow_batched(a: torch.Tensor, e_bits: torch.Tensor, spec: ModSpec) -> torch.Tensor:
    """a^e for per-lane exponents given as LSB-first bits [..., nbits]: a
    fixed nbits-step ladder, each step a multiply kept where the bit is set
    and a squaring (two K1 launches a step on CUDA)."""
    a, _ = torch.broadcast_tensors(a, e_bits[..., :1].expand(
        *e_bits.shape[:-1], a.shape[-1]))
    res = one_like(a)
    base = a.contiguous()
    for bit in e_bits.unbind(-1):
        res = select(bit.to(torch.bool), mul(res, base, spec), res)
        base = square(base, spec)
    return res
