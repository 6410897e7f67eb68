"""Hand-written Hopper kernels of Pippenger MSM and their plain PyTorch
versions (zerocaf_tpu/ops/pallas/msm_kernels.py counterpart).

  K7  ``bucket_accum_all``  signed-digit bucket tables of every window group,
                            one private table per lane
  K8  ``combine_tables``    bucket totals by the descending running sum, then
                            Horner over the windows -> one point (strided:
                            ``tail`` doublings of the result)
  K9  ``bucket_accum_k``    one group of k windows' tables (K7's kernel, one
                            group)
  K11 ``bucket_accum``      one window's tables (K7's kernel, k = 1)
  K12 ``bucket_accum2``     two windows' tables (K7's kernel, k = 2)

The TPU needed a Pallas program for each of K7, K9, K11 and K12 because
their output blocks had to fit VMEM at 128, 128, 512 and 256 lanes; on the
card they are one kernel, ``k_bucket_accum``, one thread a (window, lane),
which takes the window and lane counts as arguments.  Each entry has its
own wrapper, launch count and plain version.  K7's callers pass
``dense_lanes(n)`` lanes and K9 and K12 take them by default; K11 takes
``wide_lanes(n, 1, device)``: a launch of one window needs more lanes to
fill the card.

``k_bucket_accum`` computes on the 8 x 32-bit Montgomery core of
``csrc/field32.cuh``: ``to_field32`` (its prep kernel, with its own launch
count) converts the points to that form once a call, and the kernel
writes its tables as canonical 22 x 12-bit limbs.  The plain versions add
in the same order in the limb algebra of ``field_kernels`` and canonicalize
at the end, so kernel and plain version agree limb for limb.  ``k_combine``
(K8) computes on the same core, each point operation on four threads
(``csrc/quad32.cuh``), with the formulas of its plain version, and writes
canonical limbs: the two agree after ``limb.canonical``.

``fold=f`` (K7 and K9; ``_fold_lanes`` on the TPU) runs f rounds of the
lane tree over the tables in place after the launch: lanes 0:lanes>>f of
every entry then hold the folded sums.  On the card each round is one K5
launch; the plain versions run K5's plain version.  The TPU folded inside
the kernel to avoid a limbs-minor relayout that the card's tables do not
have.

The CUDA source is ``zerocaf_tpu_torch/csrc/msm_kernels.cu``.  Each wrapper
checks its tensors and raises on anything else; for CUDA tensors it launches
its kernel (or raises), for CPU tensors it runs the plain version.
``<wrapper>.launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import math

import torch

from ... import constants as C
from .. import limb as _l
from . import build
from .field_kernels import (L, _check_limbs, _on_cpu, _padd_ext_block,
                            _pdbl_block, identity_like, padd_tiled,
                            padd_tiled_ref)

PT = 4 * L                 # int32 of one extended point
MAX_COMBINE_WINDOWS = 128  # K8 runs four threads a window in one block
MIN_LANES = 32
MAX_LANES = 4096
ACCUM_THREADS_PER_SM = 4 * 128   # k_bucket_accum's __launch_bounds__(128, 4)
H100_SMS = 132             # the SMs of the card that a CPU tensor stands for
NW32 = 8                   # words of a field element in the 8 x 32 core


def dense_lanes(n: int) -> int:
    """Lanes (private tables) per window group for n points: a power of two
    near n / 256, between 32 and 4096, so each lane folds about 256 points
    per window.  At 2^20 points and 44 windows (11 groups of 4) K7 then
    runs 180,224 threads: 2.67 waves of ``wave_threads`` on an H100."""
    want = max(1, n >> 8)
    return min(MAX_LANES, max(MIN_LANES, 1 << (want - 1).bit_length()))


def wave_threads(device: torch.device) -> int:
    """Threads of ``k_bucket_accum`` resident at once on ``device``'s card:
    its SMs x 4 blocks of 128.  A CPU tensor has no card; its plain versions
    take an H100's 132 SMs, so that they pick the lanes the kernel picks
    there."""
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else H100_SMS)
    return sms * ACCUM_THREADS_PER_SM


def wide_lanes(n: int, windows: int, device: torch.device) -> int:
    """Lanes for a launch of only ``windows`` windows (K11: 1): the power of
    two nearest one wave of ``k_bucket_accum`` on ``device`` over the
    windows, but at least 32 points a lane, and never fewer than
    ``dense_lanes(n)``.  At 2^20 points on an H100 that is 32,768 lanes.
    More lanes cost the lane reduction more K5 work, and past some 32
    points a lane the kernel's fixed work per entry (identity stores, the
    conversion to limbs) outgrows its additions (PERF.md)."""
    wave = 1 << max(0, round(math.log2(wave_threads(device) / windows)))
    most = 1 << max(0, (n >> 5).bit_length() - 1)
    return max(dense_lanes(n), min(wave, most))


def _launch(name: str, device: torch.device, fn_name: str, *args) -> None:
    build.launch(name, device, "msm_kernels", fn_name, *args)


def _check_accum(name: str, pts, dig_g, nb: int, lanes: int,
                 fold: int = 0) -> None:
    if not isinstance(pts, torch.Tensor) or pts.dim() != 3 or pts.shape[0] != 4:
        raise ValueError(f"{name}: points must be one [4, n, {L}] tensor")
    _check_limbs(name, pts)
    if dig_g.dtype != torch.int32 or dig_g.dim() != 3:
        raise TypeError(f"{name}: digits must be int32 [ngrp, k, n], got "
                        f"{dig_g.dtype} {tuple(dig_g.shape)}")
    if dig_g.shape[2] != pts.shape[1]:
        raise ValueError(f"{name}: {dig_g.shape[2]} digits per window for "
                         f"{pts.shape[1]} points")
    if not dig_g.is_contiguous() or dig_g.device != pts.device:
        raise ValueError(f"{name}: digits must be contiguous, on {pts.device}")
    if nb < 2 or lanes < 1:
        raise ValueError(f"{name}: unsupported nb {nb} or lanes {lanes}")
    if fold < 0 or lanes % (1 << fold):
        raise ValueError(f"{name}: {fold} fold rounds do not divide {lanes} lanes")
    # the kernel's int32 thread index, point index and offsets inside a
    # window's table
    if (dig_g.shape[0] * dig_g.shape[1] * lanes >= 1 << 31
            or 4 * pts.shape[1] >= 1 << 31 or nb * lanes * PT >= 1 << 31):
        raise ValueError(f"{name}: too many threads, points or table entries")


# ---------------------------------------------------------------------------
# K7: bucket accumulation
# ---------------------------------------------------------------------------


def _identity_tables(shape, device) -> torch.Tensor:
    """[..., 4, 22] identity points (0, 1, 1, 0)."""
    tbl = torch.zeros(tuple(shape) + (4, L), dtype=torch.int32, device=device)
    tbl[..., 1, 0] = 1
    tbl[..., 2, 0] = 1
    return tbl


def _accum_ref(pts, dig_g, nb: int, lanes: int):
    """Plain version of ``k_bucket_accum``: the same per-lane tables, point
    chunk by point chunk (lane t takes the points i == t mod lanes, in
    order of i), every window and lane of a chunk at once, then
    canonicalized."""
    ngrp, k, n = dig_g.shape
    nw = ngrp * k
    dig = dig_g.reshape(nw, n)
    tbl = _identity_tables((nw, nb, lanes), pts.device)
    rows = torch.arange(nw, device=pts.device)[:, None]
    for c0 in range(0, n, lanes):
        m = min(lanes, n - c0)
        d = dig[:, c0:c0 + m]                              # [nw, m]
        cols = torch.arange(m, device=pts.device)[None, :]
        a = d.abs()
        neg = (d < 0)[..., None]
        P = pts[:, c0:c0 + m]                              # [4, m, 22]
        X = torch.where(neg, -P[0], P[0])
        T = torch.where(neg, -P[3], P[3])
        Y, Z = (P[j].expand(nw, m, L) for j in (1, 2))
        e = tbl[rows, a, cols]                             # [nw, m, 4, 22]
        R = _padd_ext_block(tuple(e[..., j, :] for j in range(4)), (X, Y, Z, T))
        upd = torch.where((d != 0)[..., None, None], torch.stack(R, dim=-2), e)
        tbl[rows, a, cols] = upd
    for w in range(nw):                   # one window at a time: less memory
        tbl[w] = _l.canonical(tbl[w], _l.FIELD)
    return tbl.reshape(ngrp, k, nb, lanes, 4, L)


# ---------------------------------------------------------------------------
# The prep kernel and the 8 x 32 core's boundary
# ---------------------------------------------------------------------------


def _limbs_to_words(x):
    """Canonical [..., 22] limbs -> [..., 8] little-endian 32-bit words
    (uint32 bits in int32)."""
    x = x.long()
    words = []
    for i in range(NW32):
        acc = torch.zeros_like(x[..., 0])
        for k in range(L):
            sh = _l.W * k - 32 * i
            if -_l.W < sh < 32:
                acc = acc | (x[..., k] << sh if sh >= 0 else x[..., k] >> -sh)
        words.append(acc & 0xFFFFFFFF)
    w = torch.stack(words, dim=-1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _mont_const(v: int, device):
    return _l.const(_l.int_limbs(v % C.P), device)


def to_field32_ref(pts):
    """Plain version of ``k_to_field32``: [4, n, 22] limbs -> [n, 4, 8]
    words of v R mod p (R = 2^256)."""
    v = _l.canonical(pts, _l.FIELD)
    mont = _l.canonical(_l.mul(v, _mont_const(C.FIELD32_R, pts.device),
                               _l.FIELD), _l.FIELD)
    return _limbs_to_words(mont).transpose(0, 1).contiguous()


def to_field32(pts):
    """The points of K7, K9, K11 and K12 in the 8 x 32 core's form:
    [4, n, 22] int32 limbs (any values the limb engine makes) -> [n, 4, 8]
    int32 holding the uint32 words of v R mod p, one 128-byte point a
    row."""
    if not isinstance(pts, torch.Tensor) or pts.dim() != 3 or pts.shape[0] != 4:
        raise ValueError(f"to_field32: points must be one [4, n, {L}] tensor")
    _check_limbs("to_field32", pts)
    if _on_cpu(pts):
        return to_field32_ref(pts)
    n = pts.shape[1]
    if 4 * n >= 1 << 31:
        raise ValueError(f"to_field32: too many points ({n})")
    out = torch.empty((n, 4, NW32), dtype=torch.int32, device=pts.device)
    if n:
        _launch("to_field32", pts.device, "zc_to_field32", pts, out, n)
        to_field32.launches += 1
    return out


to_field32.launches = 0


def _fold_lanes(tbl, fold: int, add) -> None:
    """``fold`` rounds of the lane tree over per-lane tables [..., lanes, 4,
    22], in place: round r adds lanes half:2*half into lanes 0:half (half =
    lanes >> (r+1)), each round one ``add`` of the halves, read in place.
    Lanes at and above lanes >> fold keep partial sums nobody reads."""
    lanes = tbl.shape[-3]
    arr = tbl.view(-1, lanes, 4, L)
    for r in range(fold):
        half = lanes >> (r + 1)
        out = add(tuple(arr[:, :half, j] for j in range(4)),
                  tuple(arr[:, half:2 * half, j] for j in range(4)))
        for j in range(4):
            arr[:, :half, j] = out[j]


def _accum(wrapper, pts, dig_g, nb: int, lanes: int, fold: int):
    """Check, then launch ``k_bucket_accum`` on dig_g [ngrp, k, n] and fold
    with K5 (CUDA), or run the plain version (CPU).  Returns [ngrp, k, nb,
    lanes, 4, 22]."""
    name = wrapper.__name__
    _check_accum(name, pts, dig_g, nb, lanes, fold)
    if _on_cpu(pts):
        tbl = _accum_ref(pts, dig_g, nb, lanes)
        _fold_lanes(tbl, fold, padd_tiled_ref)
        return tbl
    ngrp, k, n = dig_g.shape
    out = torch.empty((ngrp, k, nb, lanes, 4, L), dtype=torch.int32,
                      device=pts.device)
    if out.numel():
        pts32 = to_field32(pts)
        _launch(name, pts.device, "zc_bucket_accum", pts32, dig_g, out, n, nb,
                ngrp * k, lanes)
        wrapper.launches += 1
        _fold_lanes(out, fold, padd_tiled)
    return out


def bucket_accum_all_ref(pts, dig_g, nb: int, lanes: int, fold: int = 0):
    """Plain version of K7 (and of its fold, through K5's plain version)."""
    tbl = _accum_ref(pts, dig_g, nb, lanes)
    _fold_lanes(tbl, fold, padd_tiled_ref)
    return tbl


def bucket_accum_all(pts, dig_g, nb: int, lanes: int, fold: int = 0):
    """Per-lane signed-digit bucket tables of all window groups (K7).

    pts:   [4, n, 22] int32 stacked extended coordinates;
    dig_g: [ngrp, k, n] int32 signed digits in [-(nb-1), nb-1] (group g,
           window h at row h; padding windows and points have digit 0).
    Returns [ngrp, k, nb, lanes, 4, 22]: entry b of lane t of window (g, h)
    is the sum of the points i == t (mod lanes) whose digit is +-b, each
    negated for a negative digit; bucket 0 is the identity.  fold > 0 then
    folds the lanes (see the module docstring)."""
    return _accum(bucket_accum_all, pts, dig_g, nb, lanes, fold)


bucket_accum_all.launches = 0


# ---------------------------------------------------------------------------
# K9, K11, K12: K7's kernel for one window group
# ---------------------------------------------------------------------------


def _one_group(name: str, dig, k: int):
    """Digits [k, n] of one window group as K7's [1, k, n]."""
    if not isinstance(dig, torch.Tensor) or dig.dim() != 2 or dig.shape[0] != k:
        raise ValueError(f"{name}: digits must be one [{k}, n] tensor, got "
                         f"{getattr(dig, 'shape', type(dig).__name__)}")
    return dig.unsqueeze(0)


def bucket_accum_k_ref(pts, dig, nb: int, k: int, lanes: int | None = None,
                       fold: int = 0):
    """Plain version of K9."""
    dig_g = _one_group("bucket_accum_k", dig, k)
    return bucket_accum_all_ref(pts, dig_g, nb, dense_lanes(dig.shape[1]) if lanes is None else lanes,
                                fold)[0]


def bucket_accum_k(pts, dig, nb: int, k: int, lanes: int | None = None,
                   fold: int = 0):
    """One group of k windows' per-lane tables (K9): dig [k, n] signed
    digits -> [k, nb, lanes, 4, 22], as one group of ``bucket_accum_all``
    (lanes None: ``dense_lanes(n)``); fold as there."""
    dig_g = _one_group("bucket_accum_k", dig, k)
    return _accum(bucket_accum_k, pts, dig_g, nb,
                  dense_lanes(dig.shape[1]) if lanes is None else lanes, fold)[0]


bucket_accum_k.launches = 0


def bucket_accum_ref(pts, dig, nb: int, lanes: int | None = None):
    """Plain version of K11."""
    dig_g = _one_group("bucket_accum", dig, 1)
    return bucket_accum_all_ref(pts, dig_g, nb, wide_lanes(
        dig.shape[1], 1, pts.device) if lanes is None else lanes)[0]


def bucket_accum(pts, dig, nb: int, lanes: int | None = None):
    """One window's per-lane tables (K11): dig [1, n] -> [1, nb, lanes, 4,
    22] (lanes None: ``wide_lanes(n, 1, pts.device)``)."""
    dig_g = _one_group("bucket_accum", dig, 1)
    return _accum(bucket_accum, pts, dig_g, nb, wide_lanes(
        dig.shape[1], 1, pts.device) if lanes is None else lanes, 0)[0]


bucket_accum.launches = 0


def bucket_accum2_ref(pts, dig, nb: int, lanes: int | None = None):
    """Plain version of K12."""
    dig_g = _one_group("bucket_accum2", dig, 2)
    return bucket_accum_all_ref(pts, dig_g, nb, dense_lanes(dig.shape[1])
                                if lanes is None else lanes)[0]


def bucket_accum2(pts, dig, nb: int, lanes: int | None = None):
    """Two windows' per-lane tables (K12): dig [2, n] -> [2, nb, lanes, 4,
    22] (lanes None: ``dense_lanes(n)``)."""
    dig_g = _one_group("bucket_accum2", dig, 2)
    return _accum(bucket_accum2, pts, dig_g, nb, dense_lanes(dig.shape[1])
                  if lanes is None else lanes, 0)[0]


bucket_accum2.launches = 0


# ---------------------------------------------------------------------------
# K8: window combine
# ---------------------------------------------------------------------------


def combine_tables_ref(tables, nb: int, nwin: int, c: int, tail: int = 0):
    """Plain version of K8: the running sums of every window at once, then
    Horner on one point, in the kernel's order, then ``tail`` doublings."""
    S = tuple(t[:nwin] for t in tables)                    # [nwin, nb, 22]
    acc = tot = identity_like(tuple(t[:, 0] for t in S))
    for b in range(nb - 1, 0, -1):
        acc = _padd_ext_block(acc, tuple(t[:, b] for t in S))
        tot = _padd_ext_block(tot, acc)
    T = identity_like(tuple(t[0] for t in tot))
    for w in reversed(range(nwin)):
        for j in range(c):
            T = _pdbl_block(T, with_t=(j == c - 1))
        T = _padd_ext_block(T, tuple(t[w] for t in tot))
    for j in range(tail):
        T = _pdbl_block(T, with_t=(j == tail - 1))
    return T


def combine_tables(tables, nb: int, nwin: int, c: int, tail: int = 0):
    """Bucket totals and Horner (K8): tables, a 4-tuple of [nwin, nb, 22]
    bucket sums (bucket 0 unused), -> the point 2^tail sum_w 2^(c w) sum_b
    b S_wb as a 4-tuple of [22] (the kernel writes canonical limbs, the
    plain version semi limbs).  With c = c' ndev and tail = c' rank it is
    rank's share of the window-sharded combine (``parallel/msm.py``)."""
    if len(tables) != 4:
        raise ValueError(f"combine_tables: expected 4 coordinates, got {len(tables)}")
    tbl = torch.stack(tables, dim=2)                       # [nwin, nb, 4, 22]
    _check_limbs("combine_tables", tbl)
    if tuple(tbl.shape) != (nwin, nb, 4, L):
        raise ValueError(f"combine_tables: tables {tuple(tables[0].shape)}, "
                         f"expected {(nwin, nb, L)}")
    if not 1 <= nwin <= MAX_COMBINE_WINDOWS or nb < 2 or c < 1 or tail < 0:
        raise ValueError(f"combine_tables: unsupported nwin {nwin}, nb {nb}, c {c}, "
                         f"tail {tail}")
    if _on_cpu(tbl):
        return combine_tables_ref(tables, nb, nwin, c, tail)
    out = torch.empty((4, L), dtype=torch.int32, device=tbl.device)
    # the bucket sums in the core's form, [nwin][nb][4][8] words
    cv = torch.empty((nwin, nb, 4, NW32), dtype=torch.int32, device=tbl.device)
    _launch("combine_tables", tbl.device, "zc_combine", tbl, cv, out, nwin, nb, c,
            tail)
    combine_tables.launches += 1
    return tuple(out.unbind(0))


combine_tables.launches = 0


def kernel_wrappers():
    """The six wrappers, in kernel order K7, K8, K9, K11, K12, then K7's
    prep kernel."""
    return (bucket_accum_all, combine_tables, bucket_accum_k, bucket_accum,
            bucket_accum2, to_field32)


def reset_launch_counts() -> None:
    for fn in kernel_wrappers():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in kernel_wrappers()}
