"""Batched Edwards points on the Sonny curve (zerocaf_tpu/models/edwards.py
counterpart, extended coordinates).

Every point is a batch: coordinates are int32 ``[..., 22]`` limb tensors.
The unified a = -1 HWCD addition is complete on this curve, so identity and
equal operands need no special case.  Scalar multiplication runs on the
kernels of ``ops/kernels/field_kernels.py``: ``__mul__`` is the 250-step
oblivious ladder (K3 at width 1), ``mul_windowed`` at width 4 the signed
windows (K4).  Both read every table entry at every step.  Every other
width of ``mul_windowed`` takes the JAX package's unsigned windowed route
(``_scalar_mul_windowed``), whose table gather is indexed by the digit:
like the JAX package's, that route is not oblivious
(docs/CONSTANT_TIME.md).

The one exception is ``basepoint_mul``, the fixed-base comb (K6) that key
generation runs: it loads one entry of a shared table per window at the
secret digit, so it is not oblivious at cache-line granularity -- as in
the reference and the JAX package (docs/CONSTANT_TIME.md).  Its tables
are built from the port's oracle at first use and cached as ``.npy``
under ``~/.cache/zerocaf_tpu_torch/``, in the JAX package's file names
and format.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import numpy as np
import torch

from .. import constants as C
from .. import interop
from .. import oracle as o
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


def _scalar_mul_windowed(p, windows, width: int = 4):
    """Fixed-window variable-base multiplication: per-lane table of the
    2^width small multiples, then ceil(250/width) rounds of width doublings
    (T only on the last) and one addition of the entry gathered at the
    digit.  windows: [..., nwin] unsigned digits, LSB first.  The gather
    index is the (secret) digit: not oblivious."""
    p = _broadcast_point(p, windows.shape[:-1])
    tbl = [_identity_like(p), p]
    for _ in range(2, 1 << width):
        tbl.append(_add(tbl[-1], p))
    T = tuple(torch.stack([t[i] for t in tbl], dim=-2) for i in range(4))
    Q = _identity_like(p)
    for d in reversed(windows.unbind(-1)):
        for i in range(width):
            Q = _double(Q, with_t=(i == width - 1))
        idx = d.long()[..., None, None].expand(*d.shape, 1, _l.L)
        Q = _add(Q, tuple(torch.gather(Tc, -2, idx).squeeze(-2) for Tc in T))
    return Q


def _broadcast_point(p, digit_batch):
    """Broadcast point coordinates to the joint batch of point and digits,
    contiguous, as the kernels take them."""
    batch = torch.broadcast_shapes(p[0].shape[:-1], tuple(digit_batch))
    return tuple(c.expand(*batch, c.shape[-1]).contiguous() for c in p)


def _const_point(limbs, shape, device):
    return tuple(_l.const(limbs[i], device).expand(*shape, _l.L)
                 for i in range(4))


# ---------------------------------------------------------------------------
# Fixed-base comb tables
# ---------------------------------------------------------------------------

COMB_WIDTH = 13          # explicit-width default: the unsigned comb
COMB_WIDTH_SIGNED = 14   # basepoint_mul's default: the signed comb
CACHE_DIR = "~/.cache/zerocaf_tpu_torch"

_FIXED_BASE_TABLES: dict[tuple[int, bool], np.ndarray] = {}
_COMB_DEVICE_TABLES: dict[tuple, torch.Tensor] = {}


def comb_cache_path(width: int, signed: bool) -> Path:
    name = f"comb_niels_{'s_' if signed else ''}w{width}.npy"
    return Path(os.path.expanduser(CACHE_DIR)) / name


def _limbs_of_ints(vals: list[int]) -> np.ndarray:
    """Canonical python ints (< 2^256) -> int32 [len, 22] limbs."""
    raw = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals),
                        dtype=np.uint8).reshape(len(vals), 32)
    return _l.bytes_to_limbs(torch.from_numpy(raw.copy())).numpy()


def _build_comb_table(width: int, signed: bool) -> np.ndarray:
    """Entry d of window w: (y+x, y-x, 2d*x*y) of the affine point
    d * 2^(width*w) * B, from the oracle.  One batched inversion (Montgomery's
    trick) a window turns its projective multiples affine."""
    nwin, nent = _fk.comb_shape(width, signed)[:2]
    out = np.empty((nwin, nent, 3, _l.L), np.int32)
    base = o.BASEPOINT
    for w in range(nwin):
        pts = [o.IDENTITY]
        for _ in range(1, nent):
            pts.append(o.point_add(pts[-1], base))
        prefix = [1]
        for p in pts:
            prefix.append(prefix[-1] * p[2] % o.P)
        inv = o.finv(prefix[-1])
        coords = [[], [], []]
        for i in reversed(range(nent)):
            zi = inv * prefix[i] % o.P
            inv = inv * pts[i][2] % o.P
            x, y = pts[i][0] * zi % o.P, pts[i][1] * zi % o.P
            coords[0].append((y + x) % o.P)
            coords[1].append((y - x) % o.P)
            coords[2].append(2 * o.EDWARDS_D * x * y % o.P)
        for j in range(3):
            out[w, :, j] = _limbs_of_ints(coords[j][::-1])
        base = o.mul_by_pow_2(base, width)
    return out


def _comb_table_host(width: int, signed: bool) -> np.ndarray:
    """The comb table as host int32 [nwin, nent, 3, 22], from memory, the
    disk cache, or the oracle (then published to the cache atomically: a
    temporary file, then os.replace)."""
    tbl = _FIXED_BASE_TABLES.get((width, signed))
    if tbl is not None:
        return tbl
    cache = comb_cache_path(width, signed)
    if cache.exists():
        try:
            tbl = np.load(cache)
        except (OSError, ValueError):
            tbl = None                 # truncated or corrupt file: rebuild
        if tbl is not None and (tbl.shape != _fk.comb_shape(width, signed)
                                or tbl.dtype != np.int32):
            tbl = None                 # stale format: rebuild
    if tbl is None:
        tbl = _build_comb_table(width, signed)
        try:
            cache.parent.mkdir(parents=True, exist_ok=True)
            tmp = cache.with_name(f"{cache.name}.{os.getpid()}.tmp.npy")
            np.save(tmp, tbl)
            os.replace(tmp, cache)
        except OSError:
            pass
    _FIXED_BASE_TABLES[(width, signed)] = tbl
    return tbl


def _fixed_base_table(width: int = COMB_WIDTH) -> np.ndarray:
    """[ceil(250/w), 2^w, 3, 22] affine-Niels comb table of the unsigned
    comb: T[w][d] = (y+x, y-x, 2d*x*y) of d * 2^(width*w) * B."""
    return _comb_table_host(width, False)


def _fixed_base_table_signed(width: int) -> np.ndarray:
    """[ceil(250/w), 2^(w-1)+1, 3, 22] table of the signed comb: the
    non-negative multiples only, since negation is free in Niels form."""
    return _comb_table_host(width, True)


def comb_table(width: int, signed: bool, layout: str, device) -> torch.Tensor:
    """The comb table in ``layout`` on ``device`` ("core" for the kernel,
    "rows" or "packed" for its plain version), uploaded and converted once
    and kept, so that a call after the first uploads nothing."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (width, signed, layout, device)
    t = _COMB_DEVICE_TABLES.get(key)
    if t is None:
        t = _COMB_DEVICE_TABLES[key] = interop.comb_table_from_numpy(
            _comb_table_host(width, signed), width, signed, device, layout)
    return t


def _madd_niels(Q, entry):
    """Mixed addition extended + affine-Niels (y+x, y-x, 2dxy), 7M: the
    plain block of K6."""
    return _fk._madd_affine_block(Q, entry)


def _fixed_base_mul(windows, width: int = COMB_WIDTH):
    """The unsigned comb (K6; its plain version on the rows table)."""
    return _fk.fixed_base_mul_stepped(windows, width)


def _fixed_base_mul_signed(windows, width: int):
    """The signed comb (K6; its plain version on the packed table)."""
    return _fk.fixed_base_mul_stepped(windows, width, signed=True, glue="packed2")


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

    @classmethod
    def basepoint_mul(cls, scalar: Scalar, width: int | None = None,
                      use_fused: bool | None = None) -> "EdwardsPoint":
        """B*k by the fixed-base comb (K6): ceil(250/width) 7M mixed
        additions, no doublings.  width None runs the signed comb at
        COMB_WIDTH_SIGNED, an explicit width the unsigned comb at that
        width.  The kernel on CUDA (on the table in the core's form), its
        plain version on the CPU (the signed comb on the packed table, the
        unsigned on the rows table): one route on both devices.  The
        table read is indexed by the secret digit (see the module
        docstring).  use_fused is accepted for the JAX package's
        signature, where it picks its TPU kernel or its XLA comb; it has
        no effect here."""
        if width is None:
            sw = COMB_WIDTH_SIGNED
            return cls(*_fixed_base_mul_signed(scalar.windows(sw, -(-250 // sw)), sw))
        return cls(*_fixed_base_mul(scalar.windows(width, -(-250 // width)), width))

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

    def mul_windowed(self, scalar: Scalar, width: int = 4,
                     use_fused: bool | None = None) -> "EdwardsPoint":
        """Fixed-window multiplication over ceil(250/width) windows, routed
        as the JAX package routes it: width 4 runs the signed windows (K4),
        a 9-entry table read in full at every window; every other width the
        unsigned ``_scalar_mul_windowed``, whose gather is indexed by the
        digit.  use_fused is accepted for the JAX package's signature,
        where it picks its TPU kernel; it has no effect here."""
        windows = scalar.windows(width, -(-250 // width))
        if width != 4:
            return EdwardsPoint(*_scalar_mul_windowed(self._tuple(), windows,
                                                      width))
        pt = _broadcast_point(self._tuple(), windows.shape[:-1])
        return EdwardsPoint(*_fk.scalar_mul_windowed_signed(pt, windows, width))

    # -- observation --------------------------------------------------------
    @property
    def shape(self):
        return tuple(self.X.shape[:-1])

    def __getitem__(self, idx) -> "EdwardsPoint":
        return EdwardsPoint(self.X[idx], self.Y[idx], self.Z[idx], self.T[idx])

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
