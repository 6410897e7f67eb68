"""Hand-written Hopper kernels K7 and K8 of Pippenger MSM and their plain
PyTorch versions (zerocaf_tpu/ops/pallas/msm_kernels.py counterpart).

  K7 ``bucket_accum_all``  signed-digit bucket tables of every window group,
                           one private table per lane
  K8 ``combine_tables``    bucket totals by the descending running sum, then
                           Horner over the windows -> one point

The CUDA source is ``zerocaf_tpu_torch/csrc/msm_kernels.cu``.  Each wrapper
checks its tensors and raises on anything else; for CUDA tensors it launches
its kernel (or raises), for CPU tensors it runs the plain version.
``<wrapper>.launches`` counts kernel launches and nothing else.  The plain
versions use the limb algebra of ``field_kernels`` in the kernels' order, so
kernel and plain version agree limb for limb.
"""

from __future__ import annotations

import torch

from . import build
from .field_kernels import (L, _check_limbs, _on_cpu, _padd_ext_block,
                            _pdbl_block, identity_like)

PT = 4 * L                 # int32 of one extended point
MAX_COMBINE_WINDOWS = 128  # K8 runs one thread per window in one block
MIN_LANES = 32
MAX_LANES = 4096


def dense_lanes(n: int) -> int:
    """Lanes (private tables) per window group for n points: a power of two
    near n / 256, between 32 and 4096, so each lane folds about 256 points
    per window.  At 2^20 points and 11 window groups that is 45,056
    threads: 1.33 waves at K7's 2 blocks of 128 threads per SM on an H100
    (PERF.md)."""
    want = max(1, n >> 8)
    return min(MAX_LANES, max(MIN_LANES, 1 << (want - 1).bit_length()))


def _launch(name: str, device: torch.device, fn_name: str, *args) -> None:
    build.launch(name, device, "msm_kernels", fn_name, *args)


def _check_accum(name: str, pts, dig_g, nb: int, lanes: int) -> None:
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
    if nb < 2 or not 1 <= lanes <= MAX_LANES:
        raise ValueError(f"{name}: unsupported nb {nb} or lanes {lanes}")


# ---------------------------------------------------------------------------
# K7: bucket accumulation
# ---------------------------------------------------------------------------


def _identity_tables(shape, device) -> torch.Tensor:
    """[..., 4, 22] identity points (0, 1, 1, 0)."""
    tbl = torch.zeros(tuple(shape) + (4, L), dtype=torch.int32, device=device)
    tbl[..., 1, 0] = 1
    tbl[..., 2, 0] = 1
    return tbl


def bucket_accum_all_ref(pts, dig_g, nb: int, lanes: int):
    """Plain version of K7: the same per-lane tables, point chunk by point
    chunk (lane t takes the points i == t mod lanes, in order of i), every
    window and lane of a chunk at once."""
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
    return tbl.reshape(ngrp, k, nb, lanes, 4, L)


def bucket_accum_all(pts, dig_g, nb: int, lanes: int):
    """Per-lane signed-digit bucket tables of all window groups (K7).

    pts:   [4, n, 22] int32 stacked extended coordinates;
    dig_g: [ngrp, k, n] int32 signed digits in [-(nb-1), nb-1] (group g,
           window h at row h; padding windows and points have digit 0).
    Returns [ngrp, k, nb, lanes, 4, 22]: entry b of lane t of window (g, h)
    is the sum of the points i == t (mod lanes) whose digit is +-b, each
    negated for a negative digit; bucket 0 is the identity."""
    _check_accum("bucket_accum_all", pts, dig_g, nb, lanes)
    if _on_cpu(pts):
        return bucket_accum_all_ref(pts, dig_g, nb, lanes)
    ngrp, k, n = dig_g.shape
    if ngrp * lanes >= 1 << 31 or n >= 1 << 31:
        raise ValueError("bucket_accum_all: too many threads or points")
    out = torch.empty((ngrp, k, nb, lanes, 4, L), dtype=torch.int32,
                      device=pts.device)
    if out.numel():
        _launch("bucket_accum_all", pts.device, "zc_bucket_accum", pts, dig_g,
                out, n, nb, k, ngrp, lanes)
        bucket_accum_all.launches += 1
    return out


bucket_accum_all.launches = 0


# ---------------------------------------------------------------------------
# K8: window combine
# ---------------------------------------------------------------------------


def combine_tables_ref(tables, nb: int, nwin: int, c: int):
    """Plain version of K8: the running sums of every window at once, then
    Horner on one point, in the kernel's order."""
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
    return T


def combine_tables(tables, nb: int, nwin: int, c: int):
    """Bucket totals and Horner (K8): tables, a 4-tuple of [nwin, nb, 22]
    bucket sums (bucket 0 unused), -> the point sum_w 2^(c w) sum_b b S_wb
    as a 4-tuple of [22]."""
    if len(tables) != 4:
        raise ValueError(f"combine_tables: expected 4 coordinates, got {len(tables)}")
    tbl = torch.stack(tables, dim=2)                       # [nwin, nb, 4, 22]
    _check_limbs("combine_tables", tbl)
    if tuple(tbl.shape) != (nwin, nb, 4, L):
        raise ValueError(f"combine_tables: tables {tuple(tables[0].shape)}, "
                         f"expected {(nwin, nb, L)}")
    if not 1 <= nwin <= MAX_COMBINE_WINDOWS or nb < 2 or c < 1:
        raise ValueError(f"combine_tables: unsupported nwin {nwin}, nb {nb}, c {c}")
    if _on_cpu(tbl):
        return combine_tables_ref(tables, nb, nwin, c)
    out = torch.empty((4, L), dtype=torch.int32, device=tbl.device)
    _launch("combine_tables", tbl.device, "zc_combine", tbl, out, nwin, nb, c)
    combine_tables.launches += 1
    return tuple(out.unbind(0))


combine_tables.launches = 0


def kernel_wrappers():
    """The two wrappers, in kernel order K7, K8."""
    return (bucket_accum_all, combine_tables)


def reset_launch_counts() -> None:
    for fn in kernel_wrappers():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in kernel_wrappers()}
