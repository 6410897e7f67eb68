"""Checkpoint and resume of long blockwise MSM jobs
(zerocaf_tpu/parallel/checkpoint.py counterpart).

A job over B point blocks keeps one partial point; after each block the
partial and the next block's index are written, and a restarted job
resumes from the last written block.  The file format is the JAX
package's, byte for byte, so either package resumes the other's files: an
8-byte little-endian header length, a JSON header {"next_block",
"meta"}, then ``np.save`` of the partial as [4, 32] uint8, the canonical
encodings of X, Y, Z and T.  Canonical bytes do not depend on the limb
layout, the device or the framework.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

from ..config import resolve_device
from ..models.edwards import EdwardsPoint
from ..ops import limb as _l
from ..ops.limb import FIELD as _F
from .msm import msm as _msm_single
from .msm import msm_sharded as _msm_sharded


def _point_to_bytes(p: EdwardsPoint) -> np.ndarray:
    """[..., 4, 32] uint8: canonical per-coordinate encodings."""
    return torch.stack([_l.to_bytes(c, _F) for c in p._tuple()], dim=-2).cpu().numpy()


def _point_from_bytes(b: np.ndarray, device) -> EdwardsPoint:
    t = torch.as_tensor(np.ascontiguousarray(b, dtype=np.uint8), device=device)
    return EdwardsPoint(*(_l.from_bytes(t[..., i, :], _F) for i in range(4)))


def save(path: str, partial: EdwardsPoint, next_block: int,
         meta: dict | None = None) -> None:
    """Write a checkpoint atomically (a temporary file, then a rename)."""
    payload = {"next_block": int(next_block), "meta": meta or {}}
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            header = json.dumps(payload).encode()
            f.write(len(header).to_bytes(8, "little"))
            f.write(header)
            np.save(f, _point_to_bytes(partial))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(path: str, device=None) -> tuple[EdwardsPoint, int, dict] | None:
    """(partial on ``device``, next_block, meta), or None if there is no
    checkpoint at path.  device=None is ``config.default_device()``: the
    first CUDA card unless the caller set another, as for every
    constructor."""
    device = resolve_device(device)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        hlen = int.from_bytes(f.read(8), "little")
        payload = json.loads(f.read(hlen).decode())
        arr = np.load(f, allow_pickle=False)
    return _point_from_bytes(arr, device), payload["next_block"], payload["meta"]


def msm_with_checkpoints(points: EdwardsPoint, scalars, block_size: int,
                         path: str, mesh=None, c: int | None = None):
    """Blockwise MSM with a checkpoint after every block; resumes from
    ``path`` if it holds one.  Exact integer math makes the blocked sum
    equal to the one-shot MSM.  Each block goes to ``msm`` (or, with a
    mesh, to ``msm_sharded`` over this rank's block) with c, so c=None
    applies the same automatic width to every block."""
    n = points.shape[0]
    nblocks = -(-n // block_size)
    device = points.X.device
    state = load(path, device)
    if state is not None:
        acc, start, _ = state
    else:
        acc, start = EdwardsPoint.identity(device=device), 0
    for b in range(start, nblocks):
        sl = slice(b * block_size, min((b + 1) * block_size, n))
        if mesh is not None:
            part = _msm_sharded(points[sl], scalars[sl], mesh, c=c)
        else:
            part = _msm_single(points[sl], scalars[sl], c=c)
        acc = acc + part
        save(path, acc, b + 1, {"n": n, "block_size": block_size})
    return acc
