"""Hand-written Hopper kernels K1-K6 and K10 and their plain PyTorch
versions (zerocaf_tpu/ops/pallas/field_kernels.py counterpart).

  K1  ``mul_tiled``                    a*b mod p or mod r
  K2  ``pow_tiled``                    a^e for a static exponent, width-4 windows
  K3  ``scalar_mul_windowed_stepped``  unsigned windowed ladder (width 1: the
                                       oblivious bit ladder)
  K4  ``scalar_mul_windowed_signed``   signed width-4 windows, 9-entry table
  K5  ``padd_tiled``                   batched unified extended addition
  K6  ``fixed_base_mul_stepped``       fixed-base comb: B*k from a shared table
  K10 ``scalar_mul_windowed_fused``    the unsigned windowed ladder as one
                                       program (K3's kernel, its own entry)

The CUDA sources are ``zerocaf_tpu_torch/csrc/field_kernels.cu`` with
``field.cuh`` (K1, K6) and ``field32.cuh`` with ``pow32.cuh`` (K2) and
``ladder32.cuh`` (K3, K4, K10) and K5.  Each wrapper checks its tensors
(int32, limb axis 22, contiguous, one device) and raises on anything else.
For CUDA tensors it launches its kernel, or raises if the kernel library
cannot be built or the launch fails; for CPU tensors it runs the plain
version beside it.  ``<wrapper>.launches`` counts kernel launches and
nothing else.

The plain versions use the kernels' algorithm and the limb algebra of
``field.cuh`` -- the same schoolbook columns, the two-pass keep-top carries,
the cascade folds and the single carry passes (``_c1``) at the same places.
K1 and K6 compute in that algebra on the card too and agree with their
plain versions limb for limb.  K2, K3, K4, K5 and K10 compute on the 8 x
32-bit Montgomery core of ``field32.cuh`` (K2 modulo p or r) with the same
formulas and chains, so they give the same field values and write them as
canonical limbs: they agree with their plain versions after
``limb.canonical``.

Constant time: the ladders read every table entry and select by mask.
Power chains: the access pattern depends only on the public exponent (K2
reads the table entry at each public digit).  The comb (K6) loads the entry
at the secret digit, as the reference does.

Laziness bounds (radix 2^12, int32 columns), as in the JAX package:
  * semi limbs are < 2^12.1 after a carry pass;
  * multiply operands may be one add deep (<= 2^13.1): 22 * 2^26.2 < 2^30.7;
  * square operands must be semi: 23 * 2^12.1 * 2^13.1 < 2^29.8;
  * anything deeper gets one ``_c1`` pass.
"""

from __future__ import annotations

import torch

from ... import constants as C
from .. import limb
from ..limb import FIELD, ModSpec
from . import build

L = 22
POW_WIDTH = 4
MAX_TABLE = 17      # entries of the per-lane Niels table the kernel accepts
NIELS_WORDS = 32    # 32-bit words of one such entry on the 8 x 32-bit core
MAX_SIGNED_WINDOWS = 256


# ---------------------------------------------------------------------------
# Shared checks and launch plumbing
# ---------------------------------------------------------------------------


def _check_limbs(name: str, *ts: torch.Tensor, contiguous: bool = True) -> None:
    dev = ts[0].device
    for t in ts:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32 limbs, got {t.dtype}")
        if t.dim() == 0 or t.shape[-1] != L:
            raise ValueError(f"{name}: limb axis must be {L}, got {tuple(t.shape)}")
        if t.shape != ts[0].shape:
            raise ValueError(f"{name}: shapes differ: {tuple(t.shape)} vs "
                             f"{tuple(ts[0].shape)}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: tensor must be contiguous")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")


def _on_cpu(t: torch.Tensor) -> bool:
    """True where the plain version runs: the tensor lies on the CPU.  Any
    other (checked) device is CUDA, where the kernel launches or raises."""
    return t.device.type == "cpu"


def _check_windows(name: str, windows: torch.Tensor, batch) -> None:
    if windows.dtype != torch.int32:
        raise TypeError(f"{name}: windows must be int32, got {windows.dtype}")
    if tuple(windows.shape[:-1]) != tuple(batch) or windows.shape[-1] < 1:
        raise ValueError(f"{name}: windows {tuple(windows.shape)} do not match "
                         f"the point batch {tuple(batch)}")
    if not windows.is_contiguous():
        raise ValueError(f"{name}: windows must be contiguous")


def _launch(name: str, device: torch.device, fn_name: str, *args) -> None:
    build.launch(name, device, "field_kernels", fn_name, *args)


# ---------------------------------------------------------------------------
# Plain block algebra (mirrors csrc/field.cuh)
# ---------------------------------------------------------------------------


def _c1(x):
    """One keep-top carry pass (limbs |x| < 2^17 -> semi)."""
    return limb.carry_keep_top(x, extra=0, passes=1)


def _mulb(a, b, spec: ModSpec = FIELD):
    """Multiply, each operand at most one add deep -> semi."""
    return limb.reduce_to_semi_cascade(limb.school(a, b), spec)


def _sqb(a, spec: ModSpec = FIELD):
    """Square a semi operand -> semi."""
    return limb.reduce_to_semi_cascade(limb.school_square(a), spec)


def _mulb_n(lefts, rights):
    """Independent multiplies as one stacked call (lanes are independent,
    so the limbs equal those of separate _mulb calls)."""
    return _mulb(torch.stack(lefts), torch.stack(rights)).unbind(0)


def _pdbl_block(P, with_t: bool = True):
    """dbl-2008-hwcd doubling (a = -1) on (X, Y, Z[, T]); T only if with_t."""
    X, Y, Z = P[0], P[1], P[2]
    A, B, Zs = _sqb(torch.stack([X, Y, Z])).unbind(0)
    Cc = Zs + Zs                       # 2-deep
    S = _c1(X + Y)                     # semi (square operand)
    E = _c1(_sqb(S) - A - B)           # 3-deep -> carry
    G = B - A                          # 2-deep
    F = _c1(G - Cc)                    # 4-deep -> carry
    H = (-A) - B                       # 2-deep
    if with_t:
        return _mulb_n([E, G, F, E], [F, H, G, H])
    return _mulb_n([E, G, F], [F, H, G])


def _madd_block(Q, e):
    """Extended + projective-Niels addition, 8M.  e = (Y+X, Y-X, Z, 2dT),
    all semi; unified (identity entries and Q == +-e work)."""
    X1, Y1, Z1, T1 = Q
    PP, MM, TT, ZZ = _mulb_n([Y1 + X1, Y1 - X1, T1, Z1], [e[0], e[1], e[3], e[2]])
    ZZ2 = ZZ + ZZ
    E = _c1(PP - MM)
    F = _c1(ZZ2 - TT)
    G = _c1(ZZ2 + TT)
    H = PP + MM                        # 2-deep
    return _mulb_n([E, G, F, E], [F, H, G, H])


def _padd_ext_block(P, Q):
    """Unified extended-extended HWCD addition (table build only)."""
    X1, Y1, Z1, T1 = P
    X2, Y2, Z2, T2 = Q
    A, B, TT, Dd, S = _mulb_n([X1, Y1, T1, Z1, X1 + Y1], [X2, Y2, T2, Z2, X2 + Y2])
    Cc = _mulb(TT, limb.const(C.EDWARDS_D_LIMBS, T1.device))
    E = _c1(S - A - B)
    F = _c1(Dd - Cc)
    G = _c1(Dd + Cc)
    H = A + B
    return _mulb_n([E, G, F, E], [F, H, G, H])


def _niels_table(pt, nb: int):
    """Entries 0..nb-1: entry 0 is the Niels identity (1, 1, 1, 0), entry k
    is k*P as (Y+X, Y-X, Z, 2dT)."""
    X = pt[0]
    zero = torch.zeros_like(X)
    one = limb.one_like(X)
    d2 = limb.const(C.EDWARDS_2D_LIMBS, X.device)
    tbl = [(one, one, one, zero)]
    ext = tuple(pt)
    for k in range(1, nb):
        if k > 1:
            ext = _padd_ext_block(ext, pt)
        x, y, z, t = ext
        tbl.append((_c1(y + x), _c1(y - x), z, _mulb(t, d2)))
    return tbl


def _select_entry(tbl, digit):
    """One-hot read of every entry: entry ``digit`` of the table."""
    e = tbl[0]
    for k in range(1, len(tbl)):
        m = (digit == k)[..., None]
        e = tuple(torch.where(m, tk, ek) for tk, ek in zip(tbl[k], e))
    return e


def identity_like(p):
    """The extended identity (0, 1, 1, 0) with the shape and device of the
    point ``p``."""
    zero = torch.zeros_like(p[0])
    one = limb.one_like(p[0])
    return (zero, one, one, zero)


def _signed_recode(win: torch.Tensor, width: int) -> torch.Tensor:
    """Unsigned width-w windows (LSB-first) -> signed digits in
    [-2^(w-1), 2^(w-1)).  The final carry out is dropped; it is zero for
    canonical scalars (< r < 2^250 with 63 width-4 windows)."""
    h = 1 << (width - 1)
    full = 1 << width
    carry = torch.zeros_like(win[..., 0])
    out = []
    for d in win.unbind(-1):
        d = d + carry
        neg = (d >= h).to(win.dtype)
        out.append(d - neg * full)
        carry = neg
    return torch.stack(out, dim=-1)


def _flat(t: torch.Tensor) -> int:
    return t.numel() // t.shape[-1]


# ---------------------------------------------------------------------------
# K1: field / scalar multiply
# ---------------------------------------------------------------------------


def mul_tiled_ref(a, b, spec: ModSpec = FIELD):
    """Plain version of K1."""
    return _mulb(a, b, spec)


def mul_tiled(a, b, spec: ModSpec = FIELD):
    """a * b (mod spec.m), semi-reduced [..., 22] in and out (K1)."""
    _check_limbs("mul_tiled", a, b)
    if _on_cpu(a):
        return mul_tiled_ref(a, b, spec)
    out = torch.empty_like(a)
    n = _flat(a)
    if n:
        _launch("mul_tiled", a.device, "zc_mul", a, b, out, n, spec.kernel_id)
        mul_tiled.launches += 1
    return out


mul_tiled.launches = 0


# ---------------------------------------------------------------------------
# K2: fixed-exponent power chain
# ---------------------------------------------------------------------------


def pow_digits(e: int, width: int = POW_WIDTH) -> list[int]:
    """The exponent's width-bit digits, most significant first."""
    if e < 1:
        raise ValueError(f"pow_tiled needs a positive exponent, got {e}")
    nwin = -(-e.bit_length() // width)
    mask = (1 << width) - 1
    return [(e >> (width * (nwin - 1 - i))) & mask for i in range(nwin)]


def pow_tiled_ref(a, e: int, spec: ModSpec = FIELD):
    """Plain version of K2: table a^0..a^15, seed from the first digit, then
    per digit 4 squarings and, for a nonzero digit, one table multiply."""
    digits = pow_digits(e)
    tbl = [limb.one_like(a), a]
    for _ in range(2, 1 << POW_WIDTH):
        tbl.append(_mulb(tbl[-1], a, spec))
    r = tbl[digits[0]]
    for d in digits[1:]:
        for _ in range(POW_WIDTH):
            r = _sqb(r, spec)
        if d:
            r = _mulb(r, tbl[d], spec)
    return r


_POW_DIGITS: dict = {}


def pow_tiled(a, e: int, spec: ModSpec = FIELD):
    """a^e (mod spec.m) for a static exponent e > 0 (K2): [..., 22] limbs
    in (any values the limb engine makes), semi limbs out (the kernel
    writes canonical ones).  The kernel's table lives in shared memory and
    is read at each public digit."""
    _check_limbs("pow_tiled", a)
    if _on_cpu(a):
        return pow_tiled_ref(a, e, spec)
    key = (e, a.device)
    digits = _POW_DIGITS.get(key)
    if digits is None:
        digits = _POW_DIGITS[key] = torch.tensor(pow_digits(e), dtype=torch.int32,
                                                 device=a.device)
    out = torch.empty_like(a)
    n = _flat(a)
    if n:
        _launch("pow_tiled", a.device, "zc_pow", a, out, digits, digits.numel(),
                n, spec.kernel_id)
        pow_tiled.launches += 1
    return out


pow_tiled.launches = 0


# ---------------------------------------------------------------------------
# K3 / K4: windowed variable-base scalar multiplication
# ---------------------------------------------------------------------------


def scalar_mul_windowed_stepped_ref(pt, windows, width: int = 4):
    """Plain version of K3: per window (MSB first) ``width`` doublings, a
    one-hot read of all 2^width Niels entries and one 8M addition."""
    tbl = _niels_table(pt, 1 << width)
    Q = identity_like(pt)
    for i in reversed(range(windows.shape[-1])):
        for j in range(width):
            Q = _pdbl_block(Q, with_t=(j == width - 1))
        Q = _madd_block(Q, _select_entry(tbl, windows[..., i]))
    return Q


def scalar_mul_windowed_signed_ref(pt, windows, width: int = 4):
    """Plain version of K4: signed recode, then per window ``width``
    doublings, a one-hot read of all 2^(w-1)+1 entries, the sign applied by
    swapping Y+X / Y-X and negating 2dT, and one 8M addition."""
    digits = _signed_recode(windows, width)
    tbl = _niels_table(pt, (1 << (width - 1)) + 1)
    Q = identity_like(pt)
    for i in reversed(range(digits.shape[-1])):
        for j in range(width):
            Q = _pdbl_block(Q, with_t=(j == width - 1))
        d = digits[..., i]
        s = (d < 0)[..., None]
        e = _select_entry(tbl, d.abs())
        e = (torch.where(s, e[1], e[0]), torch.where(s, e[0], e[1]), e[2],
             torch.where(s, -e[3], e[3]))
        Q = _madd_block(Q, e)
    return Q


def _ladder(wrapper, pt, windows, width: int, signed: bool):
    name = wrapper.__name__
    _check_limbs(name, *pt)
    if len(pt) != 4:
        raise ValueError(f"{name}: expected 4 coordinates, got {len(pt)}")
    batch = pt[0].shape[:-1]
    _check_windows(name, windows, batch)
    nb = (1 << (width - 1)) + 1 if signed else 1 << width
    if not (1 + signed <= width and nb <= MAX_TABLE):
        raise ValueError(f"{name}: unsupported width {width}")
    nwin = windows.shape[-1]
    if signed and nwin > MAX_SIGNED_WINDOWS:
        raise ValueError(f"{name}: at most {MAX_SIGNED_WINDOWS} windows")
    if windows.device != pt[0].device:
        raise ValueError(f"{name}: windows on {windows.device}, points on "
                         f"{pt[0].device}")
    if _on_cpu(pt[0]):
        ref = (scalar_mul_windowed_signed_ref if signed
               else scalar_mul_windowed_stepped_ref)
        return ref(pt, windows, width)
    dev = pt[0].device
    n = _flat(pt[0])
    pts = torch.stack(pt)                            # [4, ..., 22]
    out = torch.empty_like(pts)
    if n:
        # the per-lane Niels tables in the core's form, [entry][piece][lane][4]
        tbl = torch.empty((nb, NIELS_WORDS, n), dtype=torch.int32, device=dev)
        _launch(name, dev, "zc_ladder", pts, windows, nwin, width, int(signed),
                tbl, out, n)
        wrapper.launches += 1
    return tuple(out.unbind(0))


def scalar_mul_windowed_stepped(pt, windows, width: int = 4):
    """k*P over unsigned width-bit windows [..., nwin] (LSB first) with a
    2^width-entry per-lane Niels table (K3).  At width 1 the windows are the
    scalar's bits: the 250-step oblivious ladder of ``EdwardsPoint.__mul__``.
    pt: 4-tuple of [..., 22] int32; returns the 4-tuple k*P."""
    return _ladder(scalar_mul_windowed_stepped, pt, windows, width, False)


scalar_mul_windowed_stepped.launches = 0


def scalar_mul_windowed_signed(pt, windows, width: int = 4):
    """k*P over unsigned width-bit windows recoded in-kernel to signed
    digits, with a (2^(w-1)+1)-entry per-lane Niels table (K4).  Equal to
    K3 for canonical scalars."""
    return _ladder(scalar_mul_windowed_signed, pt, windows, width, True)


scalar_mul_windowed_signed.launches = 0


# ---------------------------------------------------------------------------
# K5: batched unified extended addition
# ---------------------------------------------------------------------------


def padd_tiled_ref(p, q):
    """Plain version of K5."""
    return _padd_ext_block(p, q)


def _strides2(v: torch.Tensor) -> tuple[int, int]:
    """(outer, inner) element strides of an [outer, inner, 22] view; 0 for
    a dimension of size 1, whose stride is never used."""
    return tuple(s if d > 1 else 0 for d, s in zip(v.shape[:2], v.stride()[:2]))


def padd_operand(coords, inner: int):
    """One operand of K5 as the kernel reads it: its four coordinates as
    [outer, inner, 22] views with contiguous limbs and one pair of element
    strides (so, si) for all four -- the lane reduction's halves of the
    bucket tables and the scan's column views pass without a copy.
    Coordinates that have no such view are copied to contiguous planes.
    Returns (views, (so, si))."""
    views = []
    for t in coords:
        try:
            v = t.view(-1, inner, L)
        except RuntimeError:
            break
        if v.stride(2) != 1:
            break
        views.append(v)
    if len(views) < 4 or len({_strides2(v) for v in views}) != 1:
        views = [t.contiguous().view(-1, inner, L) for t in coords]
    strides = _strides2(views[0])
    if max(strides) >= 1 << 31:
        raise ValueError("padd_tiled: strides beyond int32")
    return views, strides


def padd_tiled(p, q):
    """Batched unified point addition P + Q (K5).  p, q: 4-tuples of
    [..., 22] int32 extended coordinates, all of one shape; they need not
    be contiguous, and strided views are read in place.  Returns the
    4-tuple of the sums, coordinate planes of one [4, ..., 22] tensor (the
    kernel writes canonical limbs; the plain version semi limbs)."""
    if len(p) != 4 or len(q) != 4:
        raise ValueError(f"padd_tiled: expected 4 coordinates, got {len(p)} "
                         f"and {len(q)}")
    _check_limbs("padd_tiled", *p, *q, contiguous=False)
    if _on_cpu(p[0]):
        return padd_tiled_ref(p, q)
    batch = tuple(p[0].shape[:-1])
    out = torch.empty((4,) + batch + (L,), dtype=torch.int32, device=p[0].device)
    n = _flat(p[0])
    if n:
        if n >= 1 << 31:
            raise ValueError("padd_tiled: too many lanes")
        inner = batch[-1] if batch else 1
        (p4, (p_so, p_si)), (q4, (q_so, q_si)) = (padd_operand(x, inner)
                                                  for x in (p, q))
        _launch("padd_tiled", p[0].device, "zc_padd", *p4, p_so, p_si, *q4,
                q_so, q_si, out, n, inner)
        padd_tiled.launches += 1
    return tuple(out.unbind(0))


padd_tiled.launches = 0


# ---------------------------------------------------------------------------
# K6: fixed-base comb
# ---------------------------------------------------------------------------

# int32 words of one entry of a device comb table, by layout: "rows" holds
# the three coordinates' 22 limbs (66 words), "packed" two limbs a word,
# limb i | limb i+11 << 12 (33 words); both padded so that every entry
# starts on a 16-byte boundary for the kernel's 16-byte loads.
COMB_WORDS = {"rows": 68, "packed": 36}
_GLUE_LAYOUT = {"rows": "rows", "lanes": "rows", "packed": "packed",
                "packed2": "packed"}
MAX_COMB_WIDTH = 16


def comb_shape(width: int, signed: bool) -> tuple[int, int, int, int]:
    """[nwin, nent, 3, 22]: ceil(250/width) windows of 2^width entries, or
    of 2^(width-1)+1 (the non-negative digits) for the signed comb."""
    nent = (1 << (width - 1)) + 1 if signed else 1 << width
    return (-(-250 // width), nent, 3, L)


def comb_layout(glue: str = "rows", prefetch: bool = False) -> str:
    """The device table layout that ``fixed_base_mul_stepped``'s ``glue``
    and ``prefetch`` arguments select: "packed" for "packed" and "packed2",
    "rows" for "rows", "lanes" and ``prefetch=True``."""
    if glue not in _GLUE_LAYOUT:
        raise ValueError(f"fixed_base_mul_stepped: unknown glue {glue!r}")
    return "rows" if prefetch else _GLUE_LAYOUT[glue]


def comb_entries(tbl: torch.Tensor, layout: str) -> torch.Tensor:
    """A comb table [nwin, nent, 3, 22] of canonical limbs -> the kernel's
    layout [nwin, nent, COMB_WORDS[layout]] on the same device."""
    nwin, nent = tbl.shape[:2]
    if layout == "packed":
        words = (tbl[..., :11] | (tbl[..., 11:] << limb.W)).reshape(nwin, nent, 33)
    else:
        words = tbl.reshape(nwin, nent, 3 * L)
    pad = torch.zeros((nwin, nent, COMB_WORDS[layout] - words.shape[-1]),
                      dtype=torch.int32, device=tbl.device)
    return torch.cat([words, pad], dim=-1).contiguous()


def _comb_entry(tbl: torch.Tensor, layout: str, w: int, a: torch.Tensor):
    """Entry a (per lane) of window w, unpacked: (y+x, y-x, 2dxy)."""
    e = tbl[w][a]
    if layout == "packed":
        v = e[..., :33].unflatten(-1, (3, 11))
        v = torch.cat([v & limb.MASK, v >> limb.W], dim=-1)
    else:
        v = e[..., :3 * L].unflatten(-1, (3, L))
    return v.unbind(-2)


def _madd_affine_block(Q, e):
    """Extended + affine-Niels addition, 7M.  e = (y+x, y-x, 2dxy) with
    canonical limbs, the last possibly negated (a signed digit)."""
    X1, Y1, Z1, T1 = Q
    PP, MM, TT = _mulb_n([Y1 + X1, Y1 - X1, T1], list(e))
    Z2 = Z1 + Z1                       # 2-deep
    E = _c1(PP - MM)
    F = _c1(Z2 - TT)
    G = _c1(Z2 + TT)
    H = PP + MM                        # 2-deep
    return _mulb_n([E, G, F, E], [F, H, G, H])


def _comb_ref(tbl, windows, width: int, signed: bool, layout: str):
    """The comb over a device table: digits mod 2^width (signed-recoded if
    ``signed``), then per window, LSB first, the entry at |d| with the sign
    applied by swapping y+x / y-x and negating 2dxy, and one 7M addition.
    The recoding drops its top carry, which is 0 for canonical scalars at
    every width the tables take (at width 14 the top window is at most
    4095 < 2^13)."""
    digits = windows & ((1 << width) - 1)
    if signed:
        digits = _signed_recode(digits, width)
    zero = torch.zeros(windows.shape[:-1] + (L,), dtype=torch.int32,
                       device=windows.device)
    Q = identity_like((zero,))
    for w in range(digits.shape[-1]):
        d = digits[..., w]
        s = (d < 0)[..., None]
        ep, em, et = _comb_entry(tbl, layout, w, d.abs())
        Q = _madd_affine_block(Q, (torch.where(s, em, ep), torch.where(s, ep, em),
                                   torch.where(s, -et, et)))
    return Q


def _comb_args(windows, width: int, signed: bool, glue: str, prefetch: bool):
    """Check the comb's arguments; returns (device table, layout)."""
    from ...models import edwards as _ed

    name = "fixed_base_mul_stepped"
    if not isinstance(windows, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(windows).__name__}")
    if windows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {windows.device}")
    if not 1 + signed <= width <= MAX_COMB_WIDTH:
        raise ValueError(f"{name}: unsupported width {width}")
    layout = comb_layout(glue, prefetch)
    _check_windows(name, windows, windows.shape[:-1])
    nwin = comb_shape(width, signed)[0]
    if windows.shape[-1] != nwin:
        raise ValueError(f"{name}: width {width} takes {nwin} windows, got "
                         f"{windows.shape[-1]}")
    return _ed.comb_table(width, signed, layout, windows.device), layout


def fixed_base_mul_stepped_ref(windows, width: int, signed: bool = False,
                               glue: str = "rows", prefetch: bool = False):
    """Plain version of K6, on the same device table as the kernel."""
    tbl, layout = _comb_args(windows, width, signed, glue, prefetch)
    return _comb_ref(tbl, windows, width, signed, layout)


def fixed_base_mul_stepped(windows, width: int, signed: bool = False,
                           glue: str = "rows", prefetch: bool = False):
    """B*k by the fixed-base comb (K6): windows [..., ceil(250/width)]
    int32, the scalar's unsigned width-bit digits LSB first; returns the
    4-tuple of extended coordinates.  One 7M mixed addition a window from
    the shared table of ``models.edwards``, no doublings.  ``signed``
    recodes the digits to [-2^(width-1), 2^(width-1)) and reads |d| from
    the half-size table, the sign applied by the Niels swap.

    ``glue`` and ``prefetch`` keep the JAX signature.  Its five variants
    differ only in where XLA's glue gathered and transposed the table
    entries: Mosaic could not gather, so on the TPU that glue ran outside
    the kernel.  The CUDA kernel gathers in its own body, so each value
    runs the same hand-written kernel and selects only the table layout
    it reads (``comb_layout``): "packed" and "packed2" the packed table,
    "rows", "lanes" and ``prefetch=True`` the int32 rows.

    The entry read is indexed by the (secret) digit: the comb is not
    oblivious at cache-line granularity, as in the reference and the JAX
    package (docs/CONSTANT_TIME.md)."""
    tbl, layout = _comb_args(windows, width, signed, glue, prefetch)
    if _on_cpu(windows):
        return _comb_ref(tbl, windows, width, signed, layout)
    batch = tuple(windows.shape[:-1])
    out = torch.empty((4,) + batch + (L,), dtype=torch.int32, device=windows.device)
    nwin = windows.shape[-1]
    n = windows.numel() // nwin
    if n:
        _launch("fixed_base_mul_stepped", windows.device, "zc_comb", tbl,
                windows, nwin, width, int(signed), tbl.shape[1],
                int(layout == "packed"), out, n)
        fixed_base_mul_stepped.launches += 1
    return tuple(out.unbind(0))


fixed_base_mul_stepped.launches = 0


# ---------------------------------------------------------------------------
# K10: the unsigned windowed ladder as one program
# ---------------------------------------------------------------------------


def scalar_mul_windowed_fused(pt, windows, width: int = 4):
    """k*P over unsigned width-bit windows [..., nwin] (LSB first), the
    whole ladder -- per-lane table, doublings, one-hot reads -- in one
    launch (K10).  The TPU needed a separate fused Pallas program for
    this; on the card it is K3's kernel, entered here with its own launch
    count.  Its plain version is ``scalar_mul_windowed_stepped_ref``."""
    return _ladder(scalar_mul_windowed_fused, pt, windows, width, False)


scalar_mul_windowed_fused.launches = 0


def kernel_wrappers():
    """The seven wrappers, in kernel order K1..K6, K10."""
    return (mul_tiled, pow_tiled, scalar_mul_windowed_stepped,
            scalar_mul_windowed_signed, padd_tiled, fixed_base_mul_stepped,
            scalar_mul_windowed_fused)


def reset_launch_counts() -> None:
    for fn in kernel_wrappers():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in kernel_wrappers()}
