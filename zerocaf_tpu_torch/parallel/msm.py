"""Multi-scalar multiplication (zerocaf_tpu/parallel/msm.py counterpart):
sum(k_i * P_i) by Pippenger, on one device or sharded over a mesh of ranks.

Two routes compute the same sum:

  * dense (the default): the scalars' c-bit windows are recoded to signed
    digits; K7 folds every point into per-lane bucket tables of all windows
    at once (no sort, no gather of points), the lanes are summed by K5
    (``_lane_reduce``), and K8 turns the bucket tables into one point
    (running sums, then Horner).  ``_msm_dense``'s options reach the other
    entries of K7's kernel: one window group a launch (K9,
    ``single_call=False``), one window (K11, ``k=1``) or a pair (K12,
    ``k=2``).  On CPU tensors the kernels' plain versions run.
  * scan (``dense=False``): per window, points are sorted by digit and each
    digit's segment is summed by a work-efficient segmented scan, then a
    log-depth bucket combine and Horner.  Signed digits by default,
    unsigned windows (2^c buckets) with ``signed=False``.

``msm_sharded`` runs either route on each rank's block of the batch and
sums the ranks' partial points with ``all_gather`` and a tree reduction
(``shard_combine`` instead splits the window combine across the ranks,
each rank's share one K8 call with a tail of doublings).
The ranks are processes of ``torch.distributed`` (``parallel/mesh.py``).

Every batched addition here is one K5 call on the card, at any width: the
JAX package's ``_padd`` kept narrow additions off its kernel because of
the kernel's 1024-lane Pallas blocks, which K5 does not have.  For the same
reason the JAX package's ``pallas_rounds`` (how many lane-reduce rounds may
use its kernel) is not ported: here every round is K5.

EC arithmetic is exact integer math, so the routes (and any reduction
order, any number of ranks) give the same point; they are compared by
canonical encodings.
"""

from __future__ import annotations

import torch

from ..models import edwards as _ed
from ..models.edwards import EdwardsPoint
from ..ops.kernels import field_kernels as _fk
from ..ops.kernels import msm_kernels as _mk
from ..scalar import Scalar
from .comm import Communicator

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


def _segmented_scan_points(pts, starts):
    """Inclusive segmented sum-scan with the EC addition monoid
    (Hillis-Steele: ceil(log2 N) rounds of one batched addition).  pts:
    point tuple of [N, 22]; starts: [N] int32 segment-start flags.  Each
    segment's last element ends up holding the segment's sum."""
    n = starts.shape[0]
    ident = _ed._identity_like(tuple(c[:1] for c in pts))
    f = starts
    for d in range(max(1, (n - 1).bit_length())):
        dist = min(1 << d, n)
        p_l = tuple(torch.cat([ic.expand(dist, c.shape[-1]), c[:n - dist]])
                    for c, ic in zip(pts, ident))
        f_l = torch.cat([f.new_zeros(dist), f[:n - dist]])
        pts = _ed._select(f.bool(), pts, _fk.padd_tiled(p_l, pts))
        f = f | f_l
    return pts


def _bucket_table(pt, digits, nbuckets: int, sign=None):
    """One Pippenger window: sort by digit, segmented exclusive scan, then
    scatter both the exclusive prefix and the point at each segment end
    and add the two [nbuckets]-wide tables: bucket[d] = that segment's sum.
    sign (optional [N] bool) negates the points of negative digits
    (signed digits: ``digits`` are then magnitudes)."""
    order = torch.argsort(digits, stable=True)
    d_sorted = digits[order]
    p_sorted = tuple(coord[order] for coord in pt)
    if sign is not None:
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


def _window_buckets(pt, digits, nbuckets: int):
    """One window of unsigned digits in [0, nbuckets)."""
    return _bucket_table(pt, digits, nbuckets)


def _window_buckets_signed(pt, mag, sign, nbuckets: int):
    """One window of signed digits, as magnitudes and signs."""
    return _bucket_table(pt, mag, nbuckets, sign=sign)


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


def _horner(tot, c: int, stride: int = 1):
    """sum_w 2^(c stride w) tot_w over the leading window axis, MSB first:
    c * stride doublings (T only on the last) and one addition per
    window."""
    T = _ed._identity_like(tuple(t[0] for t in tot))
    steps = c * stride
    for w in reversed(range(tot[0].shape[0])):
        for i in range(steps):
            T = _ed._double(T, with_t=(i == steps - 1))
        T = _ed._add(T, tuple(t[w] for t in tot))
    return T


def _combine_windows(tables, c: int, nbuckets: int):
    """Bucket combine + Horner merge.  tables: tuple of [nwin, nbuckets, 22]."""
    return _horner(_bucket_totals(tables, nbuckets), c)


def _msm_local_tables(pt, windows, c: int, nwin: int, signed: bool):
    """Scan-route bucket tables of one shard: windows [N, nwin] unsigned
    c-bit digits (recoded to signed digits when signed) -> tuple of
    [nwin, nb, 22], nb = 2^(c-1) + 1 signed, 2^c unsigned."""
    if signed:
        mag, sgn = signed_digits(windows, c)
        nb = (1 << (c - 1)) + 1
        per_w = [_window_buckets_signed(pt, mag[:, w], sgn[:, w], nb)
                 for w in range(nwin)]
    else:
        per_w = [_window_buckets(pt, windows[:, w], 1 << c)
                 for w in range(nwin)]
    return tuple(torch.stack([pw[i] for pw in per_w]) for i in range(4))


def _msm_local(pt, windows, c: int, nwin: int, signed: bool = True):
    """Scan-route Pippenger over one shard -> one point (tuple of [22])."""
    nb = (1 << (c - 1)) + 1 if signed else 1 << c
    return _combine_windows(_msm_local_tables(pt, windows, c, nwin, signed),
                            c, nb)


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


def _lane_tables(tbl, fold: int = 0):
    """Per-lane tables [..., nb, lanes, 4, 22] whose lanes were folded
    ``fold`` times -> the bucket sums, a tuple of [W, nb, 22] (W the
    windows in tbl).  Lanes at and above lanes >> fold are not read."""
    nb, lanes = tbl.shape[-4], tbl.shape[-3]
    arr = tbl.view(-1, lanes, 4, tbl.shape[-1])[:, : lanes >> fold]
    red = _lane_reduce(tuple(arr[:, :, j] for j in range(4)))
    return tuple(cv.view(-1, nb, cv.shape[-1]) for cv in red)


def dense_table_bytes(n: int, c: int) -> int:
    """Bytes of K7's per-lane tables for n points at window width c."""
    ngrp = -(-nwin_for(c) // DENSE_K)
    nb = (1 << (c - 1)) + 1
    return ngrp * DENSE_K * nb * _mk.dense_lanes(n) * _mk.PT * 4


def dense_digits(windows, c: int, nwin: int, k: int = DENSE_K):
    """The dense kernels' digits: the signed digits of windows [N, nwin] as
    [ngrp, k, N] int32, the windows past nwin (filling the last group)
    all 0."""
    mag, sgn = signed_digits(windows, c)
    n = mag.shape[0]
    ngrp = -(-nwin // k)
    dig = torch.zeros((ngrp * k, n), dtype=torch.int32, device=mag.device)
    dig[:nwin] = torch.where(sgn, -mag, mag).t()
    return dig.view(ngrp, k, n)


def _tables_by_group(pt, windows, c: int, nwin: int, k: int, accum,
                     fold: int = 0):
    """Bucket tables one group of k windows at a time: accum(pts, digits
    [k, N], nb) launches the group's per-lane tables at the lane count its
    wrapper picks (the windows past nwin all zero), whose lane reduction
    follows.  Returns a tuple of [nwin, nb, 22]."""
    nb = (1 << (c - 1)) + 1
    dig = dense_digits(windows, c, nwin, k)
    pts = torch.stack(pt)
    per_g = [_lane_tables(accum(pts, d, nb), fold) for d in dig]
    return tuple(torch.cat([pg[i] for pg in per_g])[:nwin] for i in range(4))


def _msm_dense_tables(pt, windows, c: int, nwin: int):
    """Bucket tables window by window: K11 once per window."""
    return _tables_by_group(pt, windows, c, nwin, 1, _mk.bucket_accum)


def _msm_dense_tables_paired(pt, windows, c: int, nwin: int):
    """Bucket tables pair by pair: K12 once per window pair (an odd nwin
    pads with a zero-digit window, whose all-identity table is dropped)."""
    return _tables_by_group(pt, windows, c, nwin, 2, _mk.bucket_accum2)


def _msm_dense_tables_k(pt, windows, c: int, nwin: int, k: int = DENSE_K,
                        fold: int = 0):
    """Bucket tables group by group: K9 once per group of k windows, with
    ``fold`` lane rounds after each launch."""
    def accum(pts, d, nb):
        return _mk.bucket_accum_k(pts, d, nb, k, fold=fold)
    return _tables_by_group(pt, windows, c, nwin, k, accum, fold)


def _msm_dense_tables_all(pt, windows, c: int, nwin: int, k: int = DENSE_K,
                          fold: int = 0):
    """Bucket tables of every window: K7 over all window groups in one
    launch, ``fold`` lane rounds, then the rest of the lane reduction over
    all windows at once.  Returns a tuple of [nwin, nb, 22]."""
    nb = (1 << (c - 1)) + 1
    dig = dense_digits(windows, c, nwin, k)
    lanes = _mk.dense_lanes(dig.shape[-1])
    tbl = _mk.bucket_accum_all(torch.stack(pt), dig, nb, lanes, fold)
    return tuple(t[:nwin] for t in _lane_tables(tbl, fold))


def _msm_dense(pt, windows, c: int, nwin: int, k: int = DENSE_K,
               fold: int = 0, fused_combine: bool = True,
               single_call: bool = True):
    """Dense MSM body: bucket tables, then the window combine.  k >= 3
    takes groups of k windows, all groups in one K7 launch
    (single_call, the default) or one K9 launch a group; k = 2 one K12
    launch a window pair; k = 1 one K11 launch a window.  fold (k >= 3
    only) folds the lanes after each launch.  fused_combine runs K8,
    otherwise the log-depth ``_combine_windows``."""
    nb = (1 << (c - 1)) + 1
    if k >= 3 and single_call:
        tables = _msm_dense_tables_all(pt, windows, c, nwin, k, fold)
    elif k >= 3:
        tables = _msm_dense_tables_k(pt, windows, c, nwin, k, fold)
    elif k == 2:
        tables = _msm_dense_tables_paired(pt, windows, c, nwin)
    else:
        tables = _msm_dense_tables(pt, windows, c, nwin)
    if fused_combine:
        return _mk.combine_tables(tables, nb, nwin, c)
    return _combine_windows(tables, c, nb)


def _use_dense(n: int, c, dense: bool | None, fused: bool = False,
               signed: bool = True) -> bool:
    """Route to the dense kernels?  They take signed digits only, at most
    MAX_COMBINE_WINDOWS windows (K8 runs one thread per window) and bucket
    tables of at most MAX_TABLE_BYTES.  An explicit dense=True outside
    those bounds, or unsigned, raises; dense=None picks the dense route
    where it fits, unless fused or unsigned asks for the scan route."""
    cd = c if c is not None else auto_c_dense(n)
    fits = (2 <= cd and nwin_for(cd) <= _mk.MAX_COMBINE_WINDOWS
            and dense_table_bytes(n, cd) <= MAX_TABLE_BYTES)
    if dense is None:
        return fits and signed and not fused
    if dense and not signed:
        raise ValueError("msm(dense=True) always uses signed digits; "
                         "signed=False is not supported on the dense path")
    if dense and not fits:
        raise ValueError(
            f"msm(dense=True) at c={cd} needs {dense_table_bytes(n, cd)} bytes "
            f"of bucket tables (limit {MAX_TABLE_BYTES}) and "
            f"{nwin_for(cd)} windows (limit {_mk.MAX_COMBINE_WINDOWS})")
    return dense


def msm(points: EdwardsPoint, scalars: Scalar, c: int | None = None,
        fused: bool = False, signed: bool = True,
        dense: bool | None = None) -> EdwardsPoint:
    """Single-device MSM: sum(k_i * P_i) over the batch axis.

    The default is the dense route at width auto_c_dense(n) (K7, K5, K8 on
    the card), with signed digits (2^(c-1) + 1 buckets a window).
    dense=False, a c whose tables do not fit, fused=True or signed=False
    takes the scan route at width auto_c(n) unless c is given; unsigned
    windows have 2^c buckets.  fused=True is the JAX package's one-graph
    form (``_msm_local``, what its shard_map traces); PyTorch runs eagerly,
    so both scan forms are the same calls here."""
    pt = points._tuple()
    n = pt[0].shape[0]
    if _use_dense(n, c, dense, fused, signed):
        cd = c if c is not None else auto_c_dense(n)
        nwin = nwin_for(cd)
        windows = scalars.windows(cd, nwin)
        return EdwardsPoint(*_msm_dense(pt, windows, cd, nwin))
    if c is None:
        c = auto_c(n)
    nwin = nwin_for(c)
    return EdwardsPoint(*_msm_local(pt, scalars.windows(c, nwin), c, nwin,
                                    signed))


# ---------------------------------------------------------------------------
# Sharded MSM
# ---------------------------------------------------------------------------


def _sharded_combine(tables, c: int, nbuckets: int, comm: Communicator,
                     ndev: int):
    """Window-sharded bucket combine: the ranks all_gather their bucket
    tables (nwin * nb * 352 bytes each), sum them per window, and rank d
    combines only the windows w == d (mod ndev):

        total = sum_d 2^(c d) * Horner_{stride=ndev}(tot_{d::ndev})

    A window count not divisible by ndev pads with all-identity tables,
    whose totals are the identity.  Rank d's share is one K8 call (its
    plain version on the CPU): running sums, Horner with c * ndev
    doublings a window, then c * d doublings, the rank's weight 2^(c d) --
    the JAX package ran a fixed doubling chain because shard_map traces one
    program for every rank.  More windows a rank than K8 takes (c = 1 on
    one or two ranks) take the log-depth combine.  Returns this rank's
    weighted partial (a tuple of [22]); the caller gathers and
    tree-reduces them."""
    nwin = tables[0].shape[0]
    k = -(-nwin // ndev)
    pad = k * ndev - nwin
    if pad:
        fill = _ed._identity_like(tuple(
            t.new_empty((pad,) + t.shape[1:]) for t in tables))
        tables = tuple(torch.cat([t, f]) for t, f in zip(tables, fill))
    g = comm.all_gather_points(tables)           # [ndev, k * ndev, nb, 22]
    my = comm.axis_index()
    loc = _tree_reduce(tuple(t[:, my::ndev] for t in g))        # [k, nb, 22]
    if k <= _mk.MAX_COMBINE_WINDOWS:
        return _mk.combine_tables(loc, nbuckets, k, c * ndev, tail=c * my)
    out = _horner(_bucket_totals(loc, nbuckets), c, stride=ndev)  # c = 1, few ranks
    for _ in range(c * my):
        out = _ed._double(out)
    return out


def msm_sharded(points: EdwardsPoint, scalars: Scalar, mesh,
                c: int | None = None, axis: str = "data",
                signed: bool = True, dense: bool = False,
                shard_combine: bool = False) -> EdwardsPoint:
    """Mesh-sharded MSM, SPMD: every rank of ``mesh`` passes its own block
    of the batch (``batch_sharding``) and gets the total of all blocks
    back.  The blocks must be of one size.  Each rank computes one partial
    point, and the partials are all_gathered and tree-reduced (one point,
    352 bytes, a rank).

    c=None picks the width from the global N, as the JAX package does.
    dense=True runs each rank's Pippenger on the dense kernels: with
    shard_combine, K9 once per window group and the window-sharded
    combine, one K8 call a rank (the JAX package's pod configuration);
    without it, K7 and K8 as ``msm``.  shard_combine on the scan route
    shares the combine the same way.  dense=True needs signed=True."""
    if dense and not signed:
        raise ValueError("msm_sharded(dense=True) requires signed=True")
    if points.X.device != mesh.device:
        raise ValueError(f"msm_sharded: points on {points.X.device}, this "
                         f"rank's mesh device is {mesh.device}")
    comm = Communicator(mesh, axis)
    ndev = comm.axis_size()
    n = points.shape[0]
    sizes = comm.all_gather(torch.tensor([n], device=mesh.device))
    if bool((sizes != n).any()):
        raise ValueError(f"msm_sharded: the ranks' blocks differ in size: "
                         f"{sizes.flatten().tolist()}")
    if c is None:
        c = (auto_c_dense if dense else auto_c)(n * ndev)
    nwin = nwin_for(c)
    nbuckets = (1 << (c - 1)) + 1 if signed else 1 << c
    windows = scalars.windows(c, nwin)
    pt = points._tuple()
    if dense and shard_combine:
        partial = _sharded_combine(_msm_dense_tables_k(pt, windows, c, nwin),
                                   c, nbuckets, comm, ndev)
    elif dense:
        partial = _msm_dense(pt, windows, c, nwin)
    elif shard_combine:
        tables = _msm_local_tables(pt, windows, c, nwin, signed)
        partial = _sharded_combine(tables, c, nbuckets, comm, ndev)
    else:
        partial = _msm_local(pt, windows, c, nwin, signed)
    return EdwardsPoint(*_tree_reduce(comm.all_gather_points(partial)))


def msm_naive(points: EdwardsPoint, scalars: Scalar) -> EdwardsPoint:
    """Ladder per point (K3) and a tree reduction: the cross-check."""
    return EdwardsPoint(*_tree_reduce((points * scalars)._tuple()))
