"""Multi-scalar multiplication on one device (zerocaf_tpu/parallel/msm.py
counterpart, single-device part): sum(k_i * P_i) by signed-digit Pippenger.

Two routes compute the same sum:

  * dense (the default): the scalars' c-bit windows are recoded to signed
    digits; K7 folds every point into per-lane bucket tables of all windows
    at once (no sort, no gather of points), the lanes are summed by K5
    (``_lane_reduce``), and K8 turns the bucket tables into one point
    (running sums, then Horner).  On CPU tensors the kernels' plain
    versions run.
  * scan (``dense=False``): per window, points are sorted by digit and each
    digit's segment is summed by a work-efficient segmented scan, then a
    log-depth bucket combine and Horner.  This is the cross-check.

Every batched addition here is one K5 call on the card, at any width: the
JAX package's ``_padd`` kept narrow additions off its kernel because of
the kernel's 1024-lane Pallas blocks, which K5 does not have.

EC arithmetic is exact integer math, so the two routes (and any reduction
order) give the same point; they are compared by canonical encodings.
"""

from __future__ import annotations

import torch

from ..models import edwards as _ed
from ..models.edwards import EdwardsPoint
from ..ops.kernels import field_kernels as _fk
from ..ops.kernels import msm_kernels as _mk
from ..scalar import Scalar

# Window-group size of K7: k windows' tables per thread.  It sets how often
# the points are re-read (once per group) against the threads' table memory;
# per-point work does not depend on it.
DENSE_K = 4

# Largest bucket-table allocation of the dense route (K7's per-lane tables;
# the first lane-reduce round holds about twice as much).
MAX_TABLE_BYTES = 8 << 30

# Bits of window coverage: the signed recode's carry out of window w lands
# in window w+1, and canonical scalars reach 2^250 - 1.
_COVER_BITS = 251


def auto_c(n: int) -> int:
    """Window width of the scan route by N: per-point work scales with
    nwin = ceil(251/c), so larger N amortizes a wider bucket combine."""
    if n <= 1 << 12:
        return 8
    if n <= 1 << 14:
        return 10
    if n <= 1 << 16:
        return 12
    return 14


def auto_c_dense(n: int) -> int:
    """Window width of the dense route.  6 is the JAX package's TPU choice;
    chip_smoke.py times c = 5, 6 and 7 on the H100 (PERF.md) for a later
    choice."""
    return 6


def nwin_for(c: int) -> int:
    return -(-_COVER_BITS // c)


def signed_digits(windows: torch.Tensor, c: int):
    """Unsigned c-bit windows [..., nwin] (LSB first) -> signed digits in
    [-(2^(c-1)-1), 2^(c-1)] as (mag, sign): mag in [0, 2^(c-1)], sign True
    where the digit is negative.  A window above half, or equal to half
    with a carry in, becomes negative and carries one into the next window
    (the carry-lookahead recurrence of the JAX package, run as a loop over
    the windows).  The carry out of the top window is zero for canonical
    scalars."""
    half = 1 << (c - 1)
    carry = torch.zeros_like(windows[..., 0])
    mags, signs = [], []
    for w in windows.unbind(-1):
        d = w + carry
        neg = d > half
        ds = torch.where(neg, d - 2 * half, d)
        mags.append(ds.abs())
        signs.append(ds < 0)
        carry = neg.to(windows.dtype)
    return torch.stack(mags, dim=-1), torch.stack(signs, dim=-1)


def _tree_reduce(points):
    """Reduce [M, ..., 22] stacked points with balanced batched adds."""
    m = points[0].shape[0]
    while m > 1:
        half = m // 2
        merged = _fk.padd_tiled(tuple(c[: 2 * half : 2] for c in points),
                                tuple(c[1 : 2 * half : 2] for c in points))
        if m % 2:
            merged = tuple(torch.cat([mc, c[-1:]], dim=0)
                           for mc, c in zip(merged, points))
        points = merged
        m = points[0].shape[0]
    return tuple(c[0] for c in points)


# ---------------------------------------------------------------------------
# Scan route
# ---------------------------------------------------------------------------


def _seg_exclusive_scan(pts, starts):
    """Work-efficient (Blelloch) segmented EXCLUSIVE sum-scan with the EC
    addition monoid.  pts: point tuple of [N, 22]; starts: [N] int32
    segment-start flags (starts[0] == 1).  out[i] = sum of the elements of
    i's segment strictly before i (identity at segment starts).  Pads to a
    power of two internally."""
    n0 = starts.shape[0]
    n = 1 << max(1, (n0 - 1).bit_length())
    ident = _ed._identity_like(tuple(c[:1] for c in pts))
    v = tuple(torch.cat([c, ic.expand(n - n0, c.shape[-1])]) for c, ic in
              zip(pts, ident))
    f_orig = torch.cat([starts, starts.new_ones(n - n0)])
    f2 = f_orig.clone()
    logn = n.bit_length() - 1

    def col(c, d, j):
        """Column j of the [n / 2^(d+1), 2^(d+1)] block view (a view)."""
        return c.view((n >> (d + 1), 1 << (d + 1)) + c.shape[1:])[:, j]

    # up-sweep: v[r] += v[l] where r's running flag is clear
    for d in range(logn):
        l, r = (1 << d) - 1, (1 << (d + 1)) - 1
        vL = tuple(col(c, d, l) for c in v)
        vR = tuple(col(c, d, r) for c in v)
        f2L, f2R = col(f2, d, l), col(f2, d, r)
        new_r = _ed._select(f2R == 0, _fk.padd_tiled(vR, vL), vR)
        for c, nc in zip(v, new_r):
            col(c, d, r).copy_(nc)
        col(f2, d, r).copy_(f2R | f2L)

    # clear the root, then down-sweep
    for c, ic in zip(v, ident):
        c[n - 1] = ic[0]
    for d in reversed(range(logn)):
        l, r = (1 << d) - 1, (1 << (d + 1)) - 1
        vL = tuple(col(c, d, l) for c in v)
        vR = tuple(col(c, d, r) for c in v)
        f_next = col(f_orig, d, l + 1)   # right half's first element
        f2L = col(f2, d, l)
        summed = _fk.padd_tiled(vL, vR)
        new_r = _ed._select(f_next == 1, _ed._identity_like(vL),
                            _ed._select(f2L == 1, vL, summed))
        for c, nc in zip(v, vR):
            col(c, d, l).copy_(nc)                      # v[l] = v[r]
        for c, nc in zip(v, new_r):
            col(c, d, r).copy_(nc)
        f2L.zero_()
    return tuple(c[:n0] for c in v)


def _window_buckets_signed(pt, mag, sign, nbuckets: int):
    """One Pippenger window of signed digits: sort by magnitude, negate
    the points of negative digits, segmented exclusive scan, then scatter
    both the exclusive prefix and the point at each segment end and add the
    two [nbuckets]-wide tables: bucket[d] = that segment's sum."""
    order = torch.argsort(mag, stable=True)
    d_sorted = mag[order]
    p_sorted = tuple(coord[order] for coord in pt)
    p_sorted = _ed._select(sign[order], _ed._neg(p_sorted), p_sorted)
    change = d_sorted[1:] != d_sorted[:-1]
    starts = torch.cat([change.new_ones(1), change]).to(torch.int32)
    excl = _seg_exclusive_scan(p_sorted, starts)
    ends = torch.cat([change, change.new_ones(1)])
    # one end per digit value; unwritten buckets stay the identity and the
    # parked rows (index nbuckets) are dropped
    idx = torch.where(ends, d_sorted, torch.full_like(d_sorted, nbuckets)).long()

    def scatter(coords):
        out = []
        for coord, limb0 in zip(coords, (0, 1, 1, 0)):
            t = torch.zeros((nbuckets + 1, coord.shape[-1]), dtype=coord.dtype,
                            device=coord.device)
            t[:, 0] = limb0
            t[idx] = coord
            out.append(t[:nbuckets])
        return tuple(out)

    return _fk.padd_tiled(scatter(excl), scatter(p_sorted))


def _ident_fill(like, rows):
    """[nwin, rows, 22] identity coordinates on ``like``'s device."""
    nwin, dev = like[0].shape[0], like[0].device
    out = []
    for limb0 in (0, 1, 1, 0):
        z = torch.zeros((nwin, rows, like[0].shape[-1]), dtype=torch.int32,
                        device=dev)
        z[..., 0] = limb0
        out.append(z)
    return tuple(out)


def _bucket_totals(tables, nbuckets: int):
    """Per-window bucket totals tot_w = sum_b b * S_b, log-depth: a suffix
    inclusive scan of S over the bucket axis (Hillis-Steele), then a
    pairwise tree reduction.  tables: tuple of [nwin, nbuckets, 22] ->
    tuple of [nwin, 22]."""
    m = nbuckets - 1
    S = tuple(t[:, 1:] for t in tables)
    d = 1
    while d < m:
        fill = _ident_fill(S, min(d, m))
        shifted = tuple(torch.cat([t[:, d:], f], dim=1) for t, f in zip(S, fill))
        S = _fk.padd_tiled(S, shifted)
        d <<= 1
    while m > 1:
        half = m // 2
        merged = _fk.padd_tiled(tuple(t[:, : 2 * half : 2] for t in S),
                                tuple(t[:, 1 : 2 * half : 2] for t in S))
        if m % 2:
            merged = tuple(torch.cat([mc, t[:, -1:]], dim=1)
                           for mc, t in zip(merged, S))
        S = merged
        m = S[0].shape[1]
    return tuple(t[:, 0] for t in S)


def _horner(tot, c: int):
    """sum_w 2^(c w) tot_w over the leading window axis, MSB first: c
    doublings (T only on the last) and one addition per window."""
    T = _ed._identity_like(tuple(t[0] for t in tot))
    for w in reversed(range(tot[0].shape[0])):
        for i in range(c):
            T = _ed._double(T, with_t=(i == c - 1))
        T = _ed._add(T, tuple(t[w] for t in tot))
    return T


def _combine_windows(tables, c: int, nbuckets: int):
    """Bucket combine + Horner merge.  tables: tuple of [nwin, nbuckets, 22]."""
    return _horner(_bucket_totals(tables, nbuckets), c)


# ---------------------------------------------------------------------------
# Dense route
# ---------------------------------------------------------------------------


def _lane_reduce(v):
    """Tree-reduce the lane axis (axis 1) of [E, W, 22] coordinate tuples
    (W a power of two) down to [E, 22]; every round is one K5 call."""
    w = v[0].shape[1]
    while w > 1:
        half = w // 2
        v = _fk.padd_tiled(tuple(cv[:, :half] for cv in v),
                           tuple(cv[:, half:w] for cv in v))
        w = half
    return tuple(cv[:, 0] for cv in v)


def dense_table_bytes(n: int, c: int) -> int:
    """Bytes of K7's per-lane tables for n points at window width c."""
    ngrp = -(-nwin_for(c) // DENSE_K)
    nb = (1 << (c - 1)) + 1
    return ngrp * DENSE_K * nb * _mk.dense_lanes(n) * _mk.PT * 4


def dense_digits(windows, c: int, nwin: int):
    """K7's digits: the signed digits of windows [N, nwin] as
    [ngrp, DENSE_K, N] int32, the windows past nwin (filling the last
    group) all 0."""
    mag, sgn = signed_digits(windows, c)
    n = mag.shape[0]
    ngrp = -(-nwin // DENSE_K)
    dig = torch.zeros((ngrp * DENSE_K, n), dtype=torch.int32, device=mag.device)
    dig[:nwin] = torch.where(sgn, -mag, mag).t()
    return dig.view(ngrp, DENSE_K, n)


def _msm_dense_tables_all(pt, windows, c: int, nwin: int):
    """Bucket tables of every window: K7 over all window groups in one
    launch, then the lane reduction.  Returns a tuple of [nwin, nb, 22]."""
    nb = (1 << (c - 1)) + 1
    dig = dense_digits(windows, c, nwin)
    lanes = _mk.dense_lanes(dig.shape[-1])
    tbl = _mk.bucket_accum_all(torch.stack(pt), dig, nb, lanes)
    arr = tbl.view(-1, lanes, 4, tbl.shape[-1])
    red = _lane_reduce(tuple(arr[:, :, j] for j in range(4)))
    return tuple(cv.reshape(-1, nb, cv.shape[-1])[:nwin] for cv in red)


def _msm_dense(pt, windows, c: int, nwin: int):
    """Dense MSM body: K7 bucket tables, lane reduction, K8 combine."""
    nb = (1 << (c - 1)) + 1
    return _mk.combine_tables(_msm_dense_tables_all(pt, windows, c, nwin),
                              nb, nwin, c)


def _use_dense(n: int, c, dense: bool | None) -> bool:
    """Route to the dense kernels?  They take at most MAX_COMBINE_WINDOWS
    windows (K8 runs one thread per window) and bucket tables of at most
    MAX_TABLE_BYTES.  An explicit dense=True outside those bounds raises;
    dense=None picks the dense route where it fits."""
    cd = c if c is not None else auto_c_dense(n)
    fits = (2 <= cd and nwin_for(cd) <= _mk.MAX_COMBINE_WINDOWS
            and dense_table_bytes(n, cd) <= MAX_TABLE_BYTES)
    if dense is None:
        return fits
    if dense and not fits:
        raise ValueError(
            f"msm(dense=True) at c={cd} needs {dense_table_bytes(n, cd)} bytes "
            f"of bucket tables (limit {MAX_TABLE_BYTES}) and "
            f"{nwin_for(cd)} windows (limit {_mk.MAX_COMBINE_WINDOWS})")
    return dense


def msm(points: EdwardsPoint, scalars: Scalar, c: int | None = None,
        dense: bool | None = None) -> EdwardsPoint:
    """Single-device MSM: sum(k_i * P_i) over the batch axis, with signed
    digits (2^(c-1) + 1 buckets a window).

    The default is the dense route at width auto_c_dense(n) (K7, K5, K8 on
    the card).  dense=False, or a c whose tables do not fit, takes the scan
    route at width auto_c(n) unless c is given."""
    pt = points._tuple()
    n = pt[0].shape[0]
    if _use_dense(n, c, dense):
        cd = c if c is not None else auto_c_dense(n)
        nwin = nwin_for(cd)
        windows = scalars.windows(cd, nwin)
        return EdwardsPoint(*_msm_dense(pt, windows, cd, nwin))
    if c is None:
        c = auto_c(n)
    nwin = nwin_for(c)
    mag, sgn = signed_digits(scalars.windows(c, nwin), c)
    nbuckets = (1 << (c - 1)) + 1
    per_w = [_window_buckets_signed(pt, mag[:, w], sgn[:, w], nbuckets)
             for w in range(nwin)]
    tables = tuple(torch.stack([pw[i] for pw in per_w]) for i in range(4))
    return EdwardsPoint(*_combine_windows(tables, c, nbuckets))


def msm_naive(points: EdwardsPoint, scalars: Scalar) -> EdwardsPoint:
    """Ladder per point (K3) and a tree reduction: the cross-check."""
    return EdwardsPoint(*_tree_reduce((points * scalars)._tuple()))
