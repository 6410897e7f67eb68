"""State carried between the JAX package and the port: limbs, points
(extended, projective or affine coordinates) and 32-byte encodings as numpy
arrays in the shared layout (int32, radix 2^12, limb axis last; uint8
bytes), and a check that both packages hold the same constants.  A device
of None is the port's default device (``config.default_device``)."""

from __future__ import annotations

import numpy as np
import torch

from . import constants as C
from .config import LIMB_MASK, NUM_LIMBS, resolve_device
from .ops.kernels import field_kernels as _fk


def limbs_from_numpy(arr, device=None) -> torch.Tensor:
    """int32 [..., 22] numpy limbs -> tensor on ``device`` (a copy)."""
    a = np.asarray(arr)
    if a.dtype != np.int32 or a.ndim == 0 or a.shape[-1] != NUM_LIMBS:
        raise ValueError(f"expected int32 [..., {NUM_LIMBS}], got "
                         f"{a.dtype} {a.shape}")
    return torch.tensor(a, device=resolve_device(device))


def bytes_from_numpy(arr, device=None) -> torch.Tensor:
    """uint8 [..., 32] numpy encodings (compressed Edwards y, Ristretto
    wire, Montgomery u) -> tensor on ``device`` (a copy)."""
    a = np.asarray(arr)
    if a.dtype != np.uint8 or a.ndim == 0 or a.shape[-1] != 32:
        raise ValueError(f"expected uint8 [..., 32], got {a.dtype} {a.shape}")
    return torch.tensor(a, device=resolve_device(device))


def limbs_to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def point_from_numpy(p, device=None, ncoords: int = 4) -> tuple[torch.Tensor, ...]:
    """An ncoords-tuple of [..., 22] arrays, or one [..., ncoords, 22]
    array -> the port's tuple of tensors: 4 coordinates for an
    ``EdwardsPoint``, 3 for a ``ProjectivePoint``, 2 for an
    ``AffinePoint``."""
    if isinstance(p, (tuple, list)):
        coords = [np.asarray(c) for c in p]
    else:
        a = np.asarray(p)
        coords = [a[..., i, :] for i in range(a.shape[-2])]
    if len(coords) != ncoords:
        raise ValueError(f"expected {ncoords} coordinates, got {len(coords)}")
    return tuple(limbs_from_numpy(np.ascontiguousarray(c), device) for c in coords)


def point_to_numpy(p) -> tuple[np.ndarray, ...]:
    """The port's 4-tuple (or an EdwardsPoint) -> 4-tuple of numpy arrays."""
    coords = p._tuple() if hasattr(p, "_tuple") else p
    return tuple(limbs_to_numpy(c) for c in coords)


def comb_table_from_numpy(arr, width: int, signed: bool, device=None,
                          layout: str = "rows") -> torch.Tensor:
    """A comb table as the JAX package keeps it (``_fixed_base_table`` or
    ``_fixed_base_table_signed``: int32 [nwin, nent, 3, 22], canonical
    limbs) -> the port's device table in ``layout``: "core" (the
    kernel's), "rows" or "packed" (the plain version's; see
    ``field_kernels.comb_entries``)."""
    a = np.asarray(arr)
    want = _fk.comb_shape(width, signed)
    if a.dtype != np.int32 or a.shape != want:
        raise ValueError(f"expected an int32 {want} comb table for width "
                         f"{width} (signed={signed}), got {a.dtype} {a.shape}")
    if a.min() < 0 or a.max() > LIMB_MASK:
        raise ValueError("comb table limbs must be canonical (0..4095)")
    if layout not in _fk.COMB_WORDS:
        raise ValueError(f"unknown comb table layout {layout!r}")
    return _fk.comb_entries(torch.tensor(a, device=device), layout)


def check_constants(ns) -> None:
    """Assert that every constant the port uses equals the same-named value
    of the namespace ``ns`` (for example ``zerocaf_tpu.constants``)."""
    for name in C.LIMB_CONSTANT_NAMES:
        mine = getattr(C, name)
        theirs = np.asarray(getattr(ns, name))
        if mine.shape != theirs.shape or not np.array_equal(mine, theirs):
            raise AssertionError(f"constant {name} differs: {mine} vs {theirs}")
    for name in C.INT_CONSTANT_NAMES:
        if getattr(C, name) != getattr(ns, name):
            raise AssertionError(f"constant {name} differs")
