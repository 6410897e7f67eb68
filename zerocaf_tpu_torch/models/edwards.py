"""Batched Edwards points on the Sonny curve (zerocaf_tpu/models/edwards.py
counterpart): extended coordinates, with projective and affine points, the
compressed-y wire format and the reference's free scalar-multiplication
functions beside them.

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

``binary_naf_mul`` runs a signed-digit ladder over host NAF digits whose
selects read both sums at every digit; ``window_naf_mul`` gathers its
table entry at the digit, so, like the comb below, it is not oblivious.

``basepoint_mul``, the fixed-base comb (K6) that key generation runs,
loads one entry of a shared table per window at the secret digit, so it
is not oblivious at cache-line granularity -- as in the reference and
the JAX package (docs/CONSTANT_TIME.md).  Its tables
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
from .. import traits as _traits
from ..config import resolve_device
from ..field import FieldElement, mask_like, random_bytes
from ..ops import inv_sqrt as _isq
from ..ops import limb as _l
from ..ops.kernels import field_kernels as _fk
from ..ops.limb import FIELD as _F
from ..scalar import Scalar
from ..utils import profiling as _prof


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
    """A constant point (4 rows of limbs) broadcast to ``shape`` on
    ``device`` (None: the default device)."""
    device = resolve_device(device)
    return tuple(_l.const(limbs[i], device).expand(*shape, _l.L)
                 for i in range(4))


def _compress(p) -> torch.Tensor:
    """CompressedEdwardsY encode: the canonical y bytes with the top bit set
    where x is not the raw Tonelli root of x^2 (one inverse and one sqrt
    chain: K2 on CUDA)."""
    X, Y, Z, _ = p
    zinv = _isq.inverse(Z)
    x = _l.mul(X, zinv, _F)
    y = _l.mul(Y, zinv, _F)
    _, raw = _isq.sqrt_raw(_l.square(x, _F))
    sign = ~_l.eq(raw, x, _F)
    b = _l.to_bytes(y, _F)
    top = b[..., 31] + torch.where(sign, 128, 0).to(torch.uint8)
    return torch.cat([b[..., :31], top[..., None]], dim=-1)


def _find_xx(y):
    """xx = (y^2 - 1) / (d y^2 - a), a = -1."""
    ys = _l.square(y, _F)
    one = _l.one_like(y)
    num = _l.sub(ys, one)
    den = _l.add(_l.mul(_l.const(C.EDWARDS_D_LIMBS, y.device), ys, _F), one)
    return _l.mul(num, _isq.inverse(den), _F)


def _from_y(y, sign):
    """The point with this y and x = mod_sqrt(xx, sign), as the reference's
    new_from_y_coord.  Returns ((X, Y, Z, T), ok)."""
    ok, x = _isq.mod_sqrt(_find_xx(y), sign)
    return (x, y, _l.one_like(y), _l.mul(x, y, _F)), ok


def _decompress(b):
    """CompressedEdwardsY decode: [..., 32] uint8 -> ((X, Y, Z, T), ok)."""
    sign = (b[..., 31] >> 7).to(torch.int32)
    yb = torch.cat([b[..., :31], (b[..., 31] & 0x0F)[..., None]], dim=-1)
    return _from_y(_l.from_bytes(yb, _F), sign)


def _new_random_point(generator, shape, draws: int, device):
    """The reference's random point, batched: ``draws`` candidate ys a lane
    (from ``generator``), the first whose xx is a square (num * den has the
    quadratic character of num / den; num == 0 is y = +-1, x = 0), lifted
    once with a random x sign.  Returns ((X, Y, Z, T), ok); ok is False
    where no draw was a square (about 2^-draws of the lanes)."""
    device = resolve_device(device)
    ys = FieldElement.random(generator, (draws,) + tuple(shape), device, _F).limbs
    signs = (random_bytes(generator, (draws,) + tuple(shape), 1, device)[..., 0]
             & 1).to(torch.int32)
    ys2 = _l.square(ys, _F)
    one = _l.one_like(ys)
    num = _l.sub(ys2, one)
    den = _l.add(_l.mul(_l.const(C.EDWARDS_D_LIMBS, device), ys2, _F), one)
    ok_d = _isq.legendre_is_qr(_l.mul(num, den, _F)) | _l.is_zero(num, _F)
    idx = torch.argmax(ok_d.to(torch.int32), dim=0)          # first valid draw
    y_sel = torch.gather(ys, 0, idx[None, ..., None].expand(1, *idx.shape, _l.L))[0]
    s_sel = torch.gather(signs, 0, idx[None])[0]
    pt, _ = _from_y(y_sel, s_sel)
    return pt, ok_d.any(dim=0)


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
_COSET_ROWS = tuple(tuple(pt[i].copy() for i in range(4))
                    for pt in C.FOUR_COSET_GROUP)


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
    def from_field_elements(cls, x: FieldElement, y: FieldElement) -> "EdwardsPoint":
        """Affine (x, y) -> extended (x, y, 1, x y)."""
        return cls(x.limbs, y.limbs, _l.one_like(x.limbs),
                   _l.mul(x.limbs, y.limbs, _F))

    @classmethod
    def new_from_y_coord(cls, y: FieldElement, sign) -> tuple["EdwardsPoint", torch.Tensor]:
        """(point, ok): x = mod_sqrt(xx, sign); ok is False where xx is not
        a square."""
        pt, ok = _from_y(y.limbs, mask_like(sign, y.limbs))
        return cls(*pt), ok

    @classmethod
    def random(cls, generator: torch.Generator, shape: tuple[int, ...] = (),
               device=None) -> "EdwardsPoint":
        """k B for uniform scalars k drawn from ``generator``: on the curve,
        in the prime-order subgroup (the ladder, K3 on CUDA).  For the
        reference's rejection-sampled point, which may lie in any coset,
        use ``new_random_point``."""
        k = Scalar.random(generator, shape, device, _l.SCALAR)
        return cls.basepoint(shape, k.limbs.device) * k

    @classmethod
    def new_random_point(cls, generator: torch.Generator, shape: tuple[int, ...] = (),
                         draws: int = 16, device=None) -> tuple["EdwardsPoint", torch.Tensor]:
        """The reference's random point: rejection-sample y over ``draws``
        candidates a lane and lift with a random x sign.  Returns (point,
        ok); ok is False on the lanes (about 2^-draws) where no candidate
        was on the curve."""
        pt, ok = _new_random_point(generator, shape, draws, device)
        return cls(*pt), ok

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
        no effect here.  Spans: ``zc.comb.recode`` (the digits) and
        ``zc.comb.mul`` (K6 and its glue)."""
        signed = width is None
        w = COMB_WIDTH_SIGNED if signed else width
        with _prof.span("comb.recode"):
            windows = scalar.windows(w, -(-250 // w))
        with _prof.span("comb.mul"):
            comb = _fixed_base_mul_signed if signed else _fixed_base_mul
            return cls(*comb(windows, w))

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

    def mul_by_cofactor(self) -> "EdwardsPoint":
        """8 P by three doublings."""
        return self.double().double().double()

    def mul_by_pow_2(self, k: int) -> "EdwardsPoint":
        """2^k P by k doublings."""
        p = self
        for _ in range(k):
            p = p.double()
        return p

    def mul_raw_int(self, k: int, nbits: int = 253) -> "EdwardsPoint":
        """k P for a python int 0 <= k < 2^nbits, not reduced mod r (the
        order check multiplies by r itself): the oblivious ladder over
        ``nbits`` LSB-first bits (K3 at width 1, nbits windows, on CUDA)."""
        if not 0 <= k < 1 << nbits:
            raise ValueError(f"mul_raw_int needs 0 <= k < 2^{nbits}")
        dev = self.X.device
        row = torch.tensor([(k >> i) & 1 for i in range(nbits)], dtype=torch.int32,
                           device=dev)
        bits = row.expand(*self.shape, nbits).contiguous()
        pt = _broadcast_point(self._tuple(), bits.shape[:-1])
        return EdwardsPoint(*_fk.scalar_mul_windowed_stepped(pt, bits, 1))

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

    def compress(self) -> torch.Tensor:
        """[..., 32] uint8 CompressedEdwardsY bytes."""
        return _compress(self._tuple())

    def select(self, cond, other: "EdwardsPoint") -> "EdwardsPoint":
        """where(cond, self, other), coordinate by coordinate."""
        mask = mask_like(cond, self.X).to(torch.bool)
        return EdwardsPoint(*_select(mask, self._tuple(), other._tuple()))

    def to_affine(self) -> "AffinePoint":
        zinv = _isq.inverse(self.Z)
        return AffinePoint(_l.mul(self.X, zinv, _F), _l.mul(self.Y, zinv, _F))

    def to_projective(self) -> "ProjectivePoint":
        return ProjectivePoint(self.X, self.Y, self.Z)

    def coset4(self) -> list["EdwardsPoint"]:
        """The four Edwards points that represent this Ristretto point: P
        and P plus each of the first three 4-torsion points."""
        return [self] + [self + EdwardsPoint(*_const_point(
            rows, self.shape, self.X.device)) for rows in _COSET_ROWS[:3]]

    def field(self, name: str) -> FieldElement:
        return FieldElement(getattr(self, name))

    def to_ints(self):
        """Host pull: a tuple of python-int coordinate arrays (tests only)."""
        return tuple(FieldElement(c).to_ints() for c in self._tuple())

    def __repr__(self) -> str:
        return f"EdwardsPoint(shape={self.shape}, device={self.X.device})"


@dataclasses.dataclass(frozen=True)
class ProjectivePoint:
    """(X:Y:Z) points, kept for the reference's surface; the port computes
    in extended coordinates."""

    X: torch.Tensor
    Y: torch.Tensor
    Z: torch.Tensor

    @classmethod
    def identity(cls, shape: tuple[int, ...] = (), device=None) -> "ProjectivePoint":
        e = EdwardsPoint.identity(shape, device)
        return cls(e.X, e.Y, e.Z)

    def to_extended(self) -> EdwardsPoint:
        """(X:Y:Z) -> (XZ, YZ, Z^2, XY)."""
        return EdwardsPoint(
            _l.mul(self.X, self.Z, _F), _l.mul(self.Y, self.Z, _F),
            _l.square(self.Z, _F), _l.mul(self.X, self.Y, _F))

    def __add__(self, other: "ProjectivePoint") -> "ProjectivePoint":
        """Projective addition (Bernstein et al. 2008), a = -1."""
        d = _l.const(C.EDWARDS_D_LIMBS, self.X.device)
        A = _l.mul(self.Z, other.Z, _F)
        B = _l.square(A, _F)
        Cc = _l.mul(self.X, other.X, _F)
        Dd = _l.mul(self.Y, other.Y, _F)
        E = _l.mul(d, _l.mul(Cc, Dd, _F), _F)
        F = _l.sub(B, E)
        G = _l.add(B, E)
        t = _l.sub(_l.sub(_l.mul(_l.add(self.X, self.Y),
                                 _l.add(other.X, other.Y), _F), Cc), Dd)
        return ProjectivePoint(
            _l.mul(A, _l.mul(F, t, _F), _F),
            _l.mul(A, _l.mul(G, _l.add(Dd, Cc), _F), _F),
            _l.mul(F, G, _F))

    def __neg__(self) -> "ProjectivePoint":
        return ProjectivePoint(_l.neg(self.X), self.Y, self.Z)

    def __sub__(self, other: "ProjectivePoint") -> "ProjectivePoint":
        return self + (-other)

    def double(self) -> "ProjectivePoint":
        """dbl-2008-bbjlp, 3M+4S, a = -1."""
        B = _l.square(_l.add(self.X, self.Y), _F)
        Cc = _l.square(self.X, _F)
        Dd = _l.square(self.Y, _F)
        E = _l.neg(Cc)
        F = _l.add(E, Dd)
        H = _l.square(self.Z, _F)
        J = _l.sub(F, _l.add(H, H))
        return ProjectivePoint(
            _l.mul(_l.sub(_l.sub(B, Cc), Dd), J, _F),
            _l.mul(F, _l.sub(E, Dd), _F),
            _l.mul(F, J, _F))

    def __mul__(self, scalar: Scalar) -> "ProjectivePoint":
        """Through the extended ladder (K3 on CUDA)."""
        return (self.to_extended() * scalar).to_projective()

    def eq(self, other: "ProjectivePoint") -> torch.Tensor:
        ex = _l.eq(_l.mul(self.X, other.Z, _F), _l.mul(other.X, self.Z, _F), _F)
        ey = _l.eq(_l.mul(self.Y, other.Z, _F), _l.mul(other.Y, self.Z, _F), _F)
        return ex & ey

    def is_valid(self) -> torch.Tensor:
        xs = _l.square(self.X, _F)
        ys = _l.square(self.Y, _F)
        zs = _l.square(self.Z, _F)
        left = _l.mul(_l.sub(ys, xs), zs, _F)
        right = _l.add(_l.square(zs, _F),
                       _l.mul(_l.const(C.EDWARDS_D_LIMBS, self.X.device),
                              _l.mul(xs, ys, _F), _F))
        return _l.eq(left, right, _F)

    @classmethod
    def new_from_y_coord(cls, y: FieldElement, sign) -> tuple["ProjectivePoint", torch.Tensor]:
        (X, Y, Z, _), ok = _from_y(y.limbs, mask_like(sign, y.limbs))
        return cls(X, Y, Z), ok

    @classmethod
    def new_random_point(cls, generator: torch.Generator, shape: tuple[int, ...] = (),
                         draws: int = 16, device=None) -> tuple["ProjectivePoint", torch.Tensor]:
        """See ``EdwardsPoint.new_random_point``."""
        (X, Y, Z, _), ok = _new_random_point(generator, shape, draws, device)
        return cls(X, Y, Z), ok

    @property
    def shape(self):
        return tuple(self.X.shape[:-1])

    def __repr__(self) -> str:
        return f"ProjectivePoint(shape={self.shape}, device={self.X.device})"


@dataclasses.dataclass(frozen=True)
class AffinePoint:
    """(x, y) points: equality, validity and the lift to extended."""

    X: torch.Tensor
    Y: torch.Tensor

    @classmethod
    def identity(cls, shape: tuple[int, ...] = (), device=None) -> "AffinePoint":
        e = EdwardsPoint.identity(shape, device)
        return cls(e.X, e.Y)

    def eq(self, other: "AffinePoint") -> torch.Tensor:
        return _l.eq(self.X, other.X, _F) & _l.eq(self.Y, other.Y, _F)

    def is_valid(self) -> torch.Tensor:
        xs = _l.square(self.X, _F)
        ys = _l.square(self.Y, _F)
        left = _l.sub(ys, xs)
        right = _l.add(_l.one_like(self.X),
                       _l.mul(_l.const(C.EDWARDS_D_LIMBS, self.X.device),
                              _l.mul(xs, ys, _F), _F))
        return _l.eq(left, right, _F)

    def to_extended(self) -> EdwardsPoint:
        return EdwardsPoint(self.X, self.Y, _l.one_like(self.X),
                            _l.mul(self.X, self.Y, _F))

    def __neg__(self) -> "AffinePoint":
        return AffinePoint(_l.neg(self.X), self.Y)

    @property
    def shape(self):
        return tuple(self.X.shape[:-1])

    def __repr__(self) -> str:
        return f"AffinePoint(shape={self.shape}, device={self.X.device})"


@dataclasses.dataclass(frozen=True)
class CompressedEdwardsY:
    """The 32-byte compressed-y wire format; equality is byte equality."""

    bytes: torch.Tensor  # [..., 32] uint8

    @classmethod
    def identity(cls, shape: tuple[int, ...] = (), device=None) -> "CompressedEdwardsY":
        b = torch.zeros(tuple(shape) + (32,), dtype=torch.uint8,
                        device=resolve_device(device))
        b[..., 0] = 1
        return cls(b)

    def decompress(self) -> tuple[EdwardsPoint, torch.Tensor]:
        pt, ok = _decompress(self.bytes)
        return EdwardsPoint(*pt), ok

    def eq(self, other: "CompressedEdwardsY") -> torch.Tensor:
        return torch.all(self.bytes == other.bytes, dim=-1)

    def __repr__(self) -> str:
        return f"CompressedEdwardsY(shape={tuple(self.bytes.shape[:-1])})"


# ---------------------------------------------------------------------------
# The reference's free scalar-multiplication functions
# ---------------------------------------------------------------------------


def _need_double(point) -> None:
    if not isinstance(point, _traits.Double):
        raise TypeError(f"{type(point).__name__} does not implement Double")


def double_and_add(point, scalar: Scalar) -> EdwardsPoint:
    """k P for any point with ``double`` and ``*`` (the Double trait):
    ``point * scalar``, the oblivious ladder (K3 on CUDA)."""
    _need_double(point)
    return point * scalar


def ltr_bin_mul(point, scalar: Scalar) -> EdwardsPoint:
    """The same ladder as ``double_and_add``; the reference's 249-bit quirk
    (see the oracle's ltr_bin_mul) is not replicated."""
    _need_double(point)
    return point * scalar


def mul_by_cofactor(point) -> EdwardsPoint:
    """8 P for any point with ``double``."""
    _need_double(point)
    return point.double().double().double()


def mul_by_pow_2(point, k: int) -> EdwardsPoint:
    """2^k P for any point with ``double``."""
    _need_double(point)
    for _ in range(k):
        point = point.double()
    return point


def _signed_digit_mul(p, digits):
    """MSB-first ladder over signed digits in {-1, 0, +1} [..., nbits]: per
    digit one doubling, then P and -P added to it in one stacked addition,
    and two selects.  The selects read both sums whatever the digit."""
    p = _broadcast_point(p, digits.shape[:-1])
    both = tuple(torch.stack(c) for c in zip(p, _neg(p)))      # [2, ..., 22]
    Q = _identity_like(p)
    for d in reversed(digits.unbind(-1)):
        Q = _double(Q)
        sums = _add(tuple(c.expand(2, *c.shape) for c in Q), both)
        Qa, Qs = tuple(c[0] for c in sums), tuple(c[1] for c in sums)
        Q = _select(d > 0, Qa, _select(d < 0, Qs, Q))
    return Q


def binary_naf_mul(point: EdwardsPoint, scalar: Scalar, nbits: int = 256) -> EdwardsPoint:
    """k P by the NAF of k (recoded on the host, ``Scalar.compute_naf``)
    and a fixed nbits-step signed-digit ladder."""
    digits = torch.as_tensor(scalar.compute_naf(nbits).astype(np.int32),
                             device=point.X.device)
    return EdwardsPoint(*_signed_digit_mul(point._tuple(), digits))


def _window_naf_mul(digits):
    """Fixed-base width-w NAF ladder, MSB first: per digit one doubling and
    one addition of the entry |d| of ``BASEPOINT_MULTIPLES_TABLE``, negated
    for a negative digit.  The gather is indexed by the digit: this path is
    not oblivious (like the comb, docs/CONSTANT_TIME.md)."""
    dev = digits.device
    table = _l.const(C.BASEPOINT_MULTIPLES_TABLE, dev)            # [126, 4, 22]
    Q = _const_point(_IDENTITY_ROWS, digits.shape[:-1], dev)
    for d in reversed(digits.unbind(-1)):
        Q = _double(Q)
        rows = table[d.abs().long()]                              # [..., 4, 22]
        entry = tuple(rows[..., i, :] for i in range(4))
        Q = _add(Q, _select(d < 0, _neg(entry), entry))
    return Q


def window_naf_mul(scalar: Scalar, width: int, nbits: int = 256) -> EdwardsPoint:
    """k B by the width-w NAF of k (recoded on the host) over the table of
    B's first 126 multiples, 2 <= width <= 7.  A zero digit adds the
    table's identity entry.  Not oblivious: see ``_window_naf_mul``."""
    if not 2 <= width <= 7:
        raise ValueError(f"window_naf_mul width must be in 2..7, got {width}")
    digits = torch.as_tensor(scalar.compute_window_naf(width, nbits).astype(np.int32),
                             device=scalar.limbs.device)
    return EdwardsPoint(*_window_naf_mul(digits))
