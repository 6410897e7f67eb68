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

Every function works on tensors with the limb axis last and broadcasts
over leading batch axes.  ``>>`` on int32 is an arithmetic shift and ``&`` is
two's complement, which the carry algebra relies on for negative limbs.
``mul``, ``square`` and ``pow_const`` (for exponents of 32 bits or more) go
through the kernel wrappers of ``ops/kernels/field_kernels.py``: a CUDA
kernel for CUDA tensors, the same algebra in plain PyTorch for CPU tensors.
The observers ``canonical``, ``to_bytes``, ``eq``, ``is_zero`` and
``canonical_geq`` run one ``k_canonical`` launch each on a CUDA tensor of an
i32x22 spec and its plain version on a CPU tensor (``canonical_tiled``);
the f32x29 backend takes the plain algebra (``canonical_plain`` and the
reads on it).

The f32x29 backend (``FIELD_F9``, ``SCALAR_F9``): 29 float32 limbs of radix
2^9 (252 = 9 * 28 keeps the fold limb-aligned).  Every partial product is
below 2^18.2 and every schoolbook column below 2^24, so float32 holds each
exactly; a carry splits a limb by floor division, exact for |x| < 2^24.
Its products take the cascade with the micro-fold, as in the JAX package,
and it is ordinary PyTorch code on every device: elementwise multiplies and
sums, never a matmul, so no TF32 setting can round it.  It reaches no
kernel: ``mul``, ``square`` and ``pow_const`` branch on the spec before the
kernel wrappers, and ``add``, ``sub`` and ``neg`` take the radix from the
dtype.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .. import constants as C
from .. import oracle
from ..config import FOLD_LIMB, LIMB_MASK, NUM_LIMBS, RADIX_BITS

F9_BITS = 9                  # radix bits of the f32x29 backend

MASK = LIMB_MASK
W = RADIX_BITS
L = NUM_LIMBS


def int_limbs(v: int) -> np.ndarray:
    """A non-negative int below 2^264 as [22] int32 limbs."""
    return np.array(oracle.int_to_limbs(v, n=L), dtype=np.int32)


@dataclasses.dataclass(frozen=True, eq=False)
class ModSpec:
    """A pseudo-Mersenne modulus m with 2^252 == -fold_c (mod m), and the
    limb backend: ``wbits`` radix bits, ``nlimbs`` limbs of ``dtype``, bit
    252 at the boundary of limb ``fold_limb``.

    ``kernel_id`` selects the row of the CUDA kernels' fold-constant table;
    None (f32x29) means the spec has no kernel.  For the scalar field
    r = 2^249 + dr the canonical range is below 2^249: ``final_fold_bits`` /
    ``final_c_limbs`` describe the last fold of ``canonical``."""

    name: str
    kernel_id: int | None
    m: int
    m_limbs: np.ndarray
    fold_c_limbs: np.ndarray
    final_fold_bits: int
    final_c_limbs: np.ndarray
    wbits: int = W
    nlimbs: int = L
    fold_limb: int = FOLD_LIMB
    dtype: torch.dtype = torch.int32

    @property
    def m64_limbs(self) -> np.ndarray:
        return _M64[self.name]


FIELD = ModSpec("field", 0, C.P, C.P_LIMBS, C.FOLD_C_P_LIMBS,
                final_fold_bits=252, final_c_limbs=C.FOLD_C_P_LIMBS)
SCALAR = ModSpec("scalar", 1, C.R, C.R_LIMBS, C.FOLD_C_R_LIMBS,
                 final_fold_bits=249, final_c_limbs=C.DELTA_R_LIMBS)
FIELD_F9 = ModSpec("field_f9", None, C.P, C.P_LIMBS_F9, C.FOLD_C_P_LIMBS_F9,
                   final_fold_bits=252, final_c_limbs=C.FOLD_C_P_LIMBS_F9,
                   wbits=F9_BITS, nlimbs=29, fold_limb=28, dtype=torch.float32)
SCALAR_F9 = ModSpec("scalar_f9", None, C.R, C.R_LIMBS_F9, C.FOLD_C_R_LIMBS_F9,
                    final_fold_bits=249, final_c_limbs=C.DELTA_R_LIMBS_F9,
                    wbits=F9_BITS, nlimbs=29, fold_limb=28, dtype=torch.float32)
BACKENDS = {"i32x22": (FIELD, SCALAR), "f32x29": (FIELD_F9, SCALAR_F9)}


def spec_limbs(v: int, spec: ModSpec) -> np.ndarray:
    """A non-negative int below 2^(wbits nlimbs) as ``spec``'s limbs, int32
    numpy; one array per value and layout, so ``const`` caches its
    tensors."""
    key = (v, spec.wbits, spec.nlimbs)
    arr = _SPEC_LIMBS.get(key)
    if arr is None:
        arr = _SPEC_LIMBS[key] = np.array(
            oracle.int_to_limbs(v, n=spec.nlimbs, w=spec.wbits), dtype=np.int32)
    return arr


_SPEC_LIMBS: dict = {}
# 64*m > 2^255 for both moduli: canonical() adds it to negative values
_M64 = {s.name: spec_limbs(s.m << 6, s) for s in (FIELD, SCALAR, FIELD_F9, SCALAR_F9)}

# Host constants moved to a device once; keyed by the id of a module-level
# array, whose reference the cache keeps so that the id stays unique.
_DEVICE_CONSTS: dict = {}


def const(arr: np.ndarray, device, dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """A module-level numpy constant as a ``dtype`` tensor on ``device``."""
    device = torch.device("cpu" if device is None else device)
    key = (id(arr), device, dtype)
    hit = _DEVICE_CONSTS.get(key)
    if hit is None:
        hit = _DEVICE_CONSTS[key] = (arr, torch.as_tensor(arr, device=device,
                                                          dtype=dtype))
    return hit[1]


def const_int(v: int, spec: ModSpec, device) -> torch.Tensor:
    """The canonical limbs of v mod m in ``spec``'s layout on ``device``."""
    return const(spec_limbs(v % spec.m, spec), device, spec.dtype)


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
    value.  After two passes the non-top limbs are in [-13, 4096+13].
    Float limbs (f32x29) split at radix 2^9 by floor division."""
    x = _pad(x, extra)
    if x.is_floating_point():
        return _carry_keep_top_f(x, passes)
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


def carry_exact(x: torch.Tensor, w: int | None = None) -> torch.Tensor:
    """Exact sequential carry at radix 2^w (default: 2^9 for float limbs,
    2^12 for int32): limbs 0..n-2 land in [0, 2^w) and the top limb keeps
    the remaining signed value.  Observation boundaries only."""
    if x.is_floating_point():
        return _carry_exact_f(x, F9_BITS if w is None else w)
    w = W if w is None else w
    mask = (1 << w) - 1
    cols = x.unbind(-1)
    c = torch.zeros_like(cols[0])
    out = []
    for xi in cols[:-1]:
        t = xi + c
        out.append(t & mask)
        c = t >> w
    out.append(cols[-1] + c)
    return torch.stack(out, dim=-1)


_SPLIT_MASKS: dict = {}


def _carry_keep_top_f(x: torch.Tensor, passes: int) -> torch.Tensor:
    """carry_keep_top on float32 limbs at radix 2^9: the carry of each limb
    but the top is floor(x / 2^9), exact because |x| < 2^24; the top limb's
    carry is masked off, so it keeps its value and the incoming carry."""
    n = x.shape[-1]
    key = (n, x.device)
    split = _SPLIT_MASKS.get(key)
    if split is None:
        split = torch.ones(n, dtype=torch.float32, device=x.device)
        split[-1] = 0
        _SPLIT_MASKS[key] = split
    r = float(1 << F9_BITS)
    for _ in range(passes):
        car = torch.floor(x * (1.0 / r)) * split
        x = x - car * r + _pad(car[..., :-1], 0, lo=1)
    return x


def _carry_exact_f(x: torch.Tensor, w: int) -> torch.Tensor:
    """carry_exact on float32 limbs at radix 2^w (floor division)."""
    r = float(1 << w)
    cols = x.unbind(-1)
    c = torch.zeros_like(cols[0])
    out = []
    for xi in cols[:-1]:
        t = xi + c
        c = torch.floor(t * (1.0 / r))
        out.append(t - c * r)
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
        dim=-2, dtype=outer.dtype)


def school(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full schoolbook columns out[k] = sum_{i+j=k} a_i b_j:
    [..., na] x [..., nb] -> [..., na+nb-1], exact inside int32 (and inside
    float32's 2^24 at radix 2^9): elementwise products and sums."""
    return _skew_sum(a[..., :, None] * b[..., None, :])


_SQ_WEIGHTS: dict = {}


def school_square(a: torch.Tensor) -> torch.Tensor:
    """Squaring columns in the symmetric form of the kernels (a_i * 2a_j
    above the diagonal, a_i^2 on it).  The columns are the same integers as
    school(a, a)."""
    n = a.shape[-1]
    key = (n, a.device, a.dtype)
    wts = _SQ_WEIGHTS.get(key)
    if wts is None:
        tri = np.triu(np.full((n, n), 2, np.int32), 1) + np.eye(n, dtype=np.int32)
        wts = _SQ_WEIGHTS[key] = torch.as_tensor(tri, device=a.device,
                                                 dtype=a.dtype)
    return _skew_sum(a[..., :, None] * (a[..., None, :] * wts))


# ---------------------------------------------------------------------------
# Pseudo-Mersenne reduction
# ---------------------------------------------------------------------------


def _fold(x: torch.Tensor, spec: ModSpec) -> torch.Tensor:
    """One fold at limb fl = spec.fold_limb (21, or 28 at radix 2^9):
    value(L) - c * value(H) (mod m), where L = x[:fl] and H = x[fl:].
    Width n -> max(fl, n - fl + len(c) - 1) + 1."""
    fl = spec.fold_limb
    lo = x[..., :fl]
    d = school(x[..., fl:], const(spec.fold_c_limbs, x.device, x.dtype))
    ncols = max(fl, d.shape[-1])
    y = _pad(lo, ncols - fl) - _pad(d, ncols - d.shape[-1])
    return carry_keep_top(y)


def reduce_to_semi_cascade(cols: torch.Tensor, spec: ModSpec,
                           micro_fold: bool = False) -> torch.Tensor:
    """Product columns -> semi-reduced nlimbs limbs, |value| < 2^253.

    Width walk of a full i32x22 product: 43 -> carry 44 -> fold 35 -> fold
    26 -> fold 22 (f32x29: 57 -> 58 -> 45 -> 32 -> 29).  ``micro_fold``
    also folds the bits >= 252 still in the top limb, for inputs whose VALUE
    may reach 2^(wbits nlimbs) (raw byte decodes); it is the only reduction
    that float columns take."""
    n, fl = spec.nlimbs, spec.fold_limb
    x = carry_keep_top(cols)
    while x.shape[-1] > n:
        x = _fold(x, spec)
    x = _pad(x, n - x.shape[-1])
    if micro_fold:
        d = school(x[..., fl:], const(spec.fold_c_limbs, x.device, x.dtype))
        z = _pad(x[..., :fl], n - fl)
        z = z - _pad(d, n - d.shape[-1])
        x = carry_keep_top(z, extra=0)
    return x


def reduce_to_semi(cols: torch.Tensor, spec: ModSpec) -> torch.Tensor:
    """Product or byte columns -> semi-reduced limbs, |value| < 2^253: the
    cascade with the micro-fold of the bits >= 252 (at limb FOLD_LIMB).
    The JAX package's reduce_to_semi folds the high limbs by one int8
    matrix product instead, the TPU's MXU route to the same values."""
    return reduce_to_semi_cascade(cols, spec, micro_fold=True)


# ---------------------------------------------------------------------------
# Semi-reduced ring ops
# ---------------------------------------------------------------------------


def mul(a: torch.Tensor, b: torch.Tensor, spec: ModSpec) -> torch.Tensor:
    """a * b (mod m), semi-reduced in and out (one add deep allowed).  Runs
    the K1 kernel on CUDA tensors; an f32x29 spec is plain PyTorch on every
    device."""
    from .kernels import field_kernels as fk

    if spec.kernel_id is None:
        return reduce_to_semi(school(a, b), spec)
    a, b = torch.broadcast_tensors(a, b)
    return fk.mul_tiled(a.contiguous(), b.contiguous(), spec)


def square(a: torch.Tensor, spec: ModSpec) -> torch.Tensor:
    """a^2 (mod m); the operand must be semi-reduced."""
    if spec.kernel_id is None:
        return reduce_to_semi(school_square(a), spec)
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


def _observe(x: torch.Tensor, spec: ModSpec, mode: str, **kw) -> torch.Tensor:
    """``mode``'s read of x's canonical value by ``canonical_tiled``: one
    ``k_canonical`` launch on CUDA, the plain version on the CPU."""
    from .kernels import field_kernels as fk

    return fk.canonical_tiled(x.contiguous(), spec, mode, **kw)


def canonical(x: torch.Tensor, spec: ModSpec) -> torch.Tensor:
    """Semi-reduced -> canonical [0, m) with exact limbs in [0, 2^wbits), in
    the input's dtype: ``canonical_plain``, in one ``k_canonical`` launch on
    a CUDA tensor of an i32x22 spec."""
    if spec.kernel_id is None:
        return canonical_plain(x, spec)
    return _observe(x, spec, "limbs")


def canonical_plain(x: torch.Tensor, spec: ModSpec) -> torch.Tensor:
    """Semi-reduced -> canonical [0, m) with exact limbs in [0, 2^wbits), in
    the input's dtype, in PyTorch.  Accepts any value in (-2^255, 2^255):
      1. exact carry; if negative, add 64*m (> 2^255);
      2. fold the bits above 2^k (k = 252 for p, 249 for r):
         low + h*2^k == low - h*c (mod m), h < 2^10;
      3. the result is in (-m, m): one conditional add of m.
    Float limbs are cast to int32 after step 1, exactly: every limb is then
    below 2^9 but the top, which is below 2^7."""
    dev, w, n, out_dtype = x.device, spec.wbits, spec.nlimbs, x.dtype
    x = carry_exact(x, w)
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    x = x + torch.where((x[..., -1] < 0)[..., None],
                        const(spec.m64_limbs, dev, x.dtype), zero)
    x = carry_exact(x, w)  # non-negative, < 2^259
    if x.is_floating_point():
        x, zero = x.to(torch.int32), zero.to(torch.int32)

    limb_i, bit_i = divmod(spec.final_fold_bits, w)
    if bit_i == 0:
        h = x[..., limb_i]
        lo = _pad(x[..., :limb_i], n - limb_i)
    else:
        h = (x[..., limb_i] >> bit_i) + (x[..., limb_i + 1] << (w - bit_i))
        low_bits = (x[..., limb_i] & ((1 << bit_i) - 1))[..., None]
        lo = _pad(torch.cat([x[..., :limb_i], low_bits], dim=-1),
                  n - limb_i - 1)
    d = school(h[..., None], const(spec.final_c_limbs, dev))
    y = carry_exact(lo - _pad(d, n - d.shape[-1]), w)
    y = y + torch.where((y[..., -1] < 0)[..., None],
                        const(spec.m_limbs, dev), zero)
    return carry_exact(y, w).to(out_dtype)


def eq(a: torch.Tensor, b: torch.Tensor, spec: ModSpec) -> torch.Tensor:
    """Canonical equality mask (one launch for both operands on CUDA)."""
    if spec.kernel_id is None:
        return torch.all(canonical_plain(a, spec) == canonical_plain(b, spec), dim=-1)
    a, b = torch.broadcast_tensors(a, b)
    return _observe(a, spec, "eq", other=b.contiguous())


def is_zero(a: torch.Tensor, spec: ModSpec) -> torch.Tensor:
    if spec.kernel_id is None:
        return torch.all(canonical_plain(a, spec) == 0, dim=-1)
    return _observe(a, spec, "zero")


def canonical_geq(x: torch.Tensor, bound_limbs: np.ndarray,
                  spec: ModSpec) -> torch.Tensor:
    """canonical(x) >= bound, in one launch on CUDA; branch-free.  The bound
    is canonical limbs of ``spec``'s layout held at module level or from
    ``spec_limbs``: ``const`` keeps a device copy of every array it is
    given."""
    if spec.kernel_id is None:
        return geq_const(canonical_plain(x, spec), bound_limbs)
    return _observe(x, spec, "geq", bound=bound_limbs)


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
    ca = canonical(a, spec).to(torch.int32)
    cb = canonical(b, spec).to(torch.int32)
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


def _bit_weights(w: int, device) -> torch.Tensor:
    key = (w, device)
    t = _BIT_WEIGHTS.get(key)
    if t is None:
        t = _BIT_WEIGHTS[key] = 1 << torch.arange(w, dtype=torch.int32,
                                                  device=device)
    return t


_BIT_WEIGHTS: dict = {}


def bytes_to_limbs_gen(b: torch.Tensor, spec: ModSpec) -> torch.Tensor:
    """[..., 32] uint8 -> [..., nlimbs] raw limbs of ``spec``'s radix and
    dtype, by a full bit expansion (the 12-bit backend keeps the nibble
    shuffle of ``bytes_to_limbs``)."""
    w, n = spec.wbits, spec.nlimbs
    bi = b.to(torch.int32)
    shifts = torch.arange(8, dtype=torch.int32, device=b.device)
    bits = ((bi[..., None] >> shifts) & 1).reshape(*b.shape[:-1], 256)
    g = _pad(bits, w * n - 256).reshape(*b.shape[:-1], n, w)
    return (g * _bit_weights(w, b.device)).sum(-1, dtype=torch.int32).to(spec.dtype)


def limbs_to_bytes_gen(x: torch.Tensor, spec: ModSpec) -> torch.Tensor:
    """[..., nlimbs] canonical limbs of any radix -> [..., 32] uint8 LE."""
    w, n = spec.wbits, spec.nlimbs
    xi = x.to(torch.int32)
    shifts = torch.arange(w, dtype=torch.int32, device=x.device)
    bits = ((xi[..., None] >> shifts) & 1).reshape(*x.shape[:-1], n * w)
    g = bits[..., :256].reshape(*x.shape[:-1], 32, 8)
    return (g * _bit_weights(8, x.device)).sum(-1, dtype=torch.int32).to(torch.uint8)


def from_bytes(b: torch.Tensor, spec: ModSpec) -> torch.Tensor:
    """Decode 32 LE bytes to a semi-reduced element (the raw 256-bit value
    reduced mod m)."""
    if spec.kernel_id is None:
        return reduce_to_semi(bytes_to_limbs_gen(b, spec), spec)
    return reduce_to_semi(bytes_to_limbs(b), spec)


def to_bytes(x: torch.Tensor, spec: ModSpec) -> torch.Tensor:
    """The canonical value as 32 little-endian bytes (one launch on CUDA)."""
    if spec.kernel_id is None:
        return limbs_to_bytes_gen(canonical_plain(x, spec), spec)
    return _observe(x, spec, "bytes")


# ---------------------------------------------------------------------------
# Bits and small-int embedding
# ---------------------------------------------------------------------------


def to_bits(x: torch.Tensor, spec: ModSpec, nbits: int = 256) -> torch.Tensor:
    """Canonical LSB-first bits [..., nbits] int32."""
    w, n = spec.wbits, spec.nlimbs
    xc = canonical(x, spec).to(torch.int32)
    shifts = torch.arange(w, dtype=torch.int32, device=x.device)
    bits = ((xc[..., None] >> shifts) & 1).reshape(*x.shape[:-1], n * w)
    return _pad(bits, max(0, nbits - n * w))[..., :nbits].contiguous()


def from_int(v: int, spec: ModSpec, device=None) -> torch.Tensor:
    """A python int as a canonical [nlimbs] limb tensor of ``spec``."""
    return torch.tensor(oracle.int_to_limbs(v % spec.m, n=spec.nlimbs, w=spec.wbits),
                        dtype=spec.dtype, device=device)


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
    shorter ones, and every f32x29 exponent, a plain MSB-first
    square-and-multiply."""
    from .kernels import field_kernels as fk

    if e < 0:
        raise ValueError(f"negative exponent {e}")
    if e.bit_length() >= 32 and spec.kernel_id is not None:
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
