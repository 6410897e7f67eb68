"""Limb layout of the PyTorch port (zerocaf_tpu/config.py counterpart).

The port keeps the reference's tensor boundary: int32 ``[..., 22]`` limbs,
radix 2^12, limb axis last.  Every schoolbook column of two 12-bit-limb
operands stays inside a signed int32 (22 * 2^24 < 2^28.5), which is what the
hand-written CUDA kernels and their plain PyTorch versions both rely on.

``MeshConfig`` describes the mesh of ranks that sharded MSM runs on.

There is no ``use_pallas`` switch: a kernel wrapper launches its CUDA kernel
for a CUDA tensor and runs its plain version for a CPU tensor.  The plain
versions run only on CPU tensors; a switch that ran them on the card would
hide the kernels.

The limb backend: ``FieldElement`` and ``Scalar`` constructors given no
``spec`` take the active backend's ``ModSpec`` (``ops/limb.BACKENDS``).
"i32x22" (the default) is the int32 radix-2^12 layout above, whose products
are the CUDA kernels on the card; "f32x29" is 29 float32 limbs of radix
2^9, whose every operation is ordinary PyTorch code on every device, as it
is plain ``jnp`` in the JAX package.  Point types stay on i32x22 whatever
backend is active.  ``set_backend``, ``get_backend`` and ``use_backend``
choose it.

The default device: every public constructor of the port (``from_int``,
``zero``, ``random``, ``identity``, ``basepoint`` and the others) places its
tensors on ``default_device()`` when the caller names no device.  That is
the first CUDA card, and asking for it raises where there is none: nothing
falls back to the CPU by itself.  ``set_default_device("cpu")`` or, for a
block, ``with use_device("cpu"):`` asks for the CPU, where the kernels'
plain versions run.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

RADIX_BITS: int = 12
RADIX: int = 1 << RADIX_BITS
LIMB_MASK: int = RADIX - 1
NUM_LIMBS: int = 22
FOLD_LIMB: int = 21          # limbs[21:] hold bits >= 252
FOLD_BITS: int = 252
# Carry passes that bring int32 columns to loose limbs (each pass: x & mask,
# x >> 12 added one limb up; after 3 passes limbs are <= 2^12).
CARRY_PASSES: int = 3


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Layout of the mesh that sharded workloads (MSM) run on: one axis,
    ``data_axis``, that splits the point and scalar batch over the ranks of
    ``torch.distributed``.  n_devices=None takes every rank; a number d,
    at most the world size, takes ranks 0..d-1 (``parallel.mesh.make_mesh``
    gives the others None).  A d above the world size raises where the JAX
    package would take the devices there are."""

    data_axis: str = "data"
    n_devices: int | None = None


@dataclasses.dataclass(frozen=True)
class Config:
    """Top-level settings: the mesh, host-side range checks on limb values,
    and the limb backend of ``FieldElement`` and ``Scalar``."""

    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    debug_checks: bool = False
    backend: str = "i32x22"


DEFAULT = Config()

BACKEND_NAMES = ("i32x22", "f32x29")
_ACTIVE_BACKEND = "i32x22"


def set_backend(name: str) -> None:
    """Select the limb backend of new FieldElement and Scalar values."""
    global _ACTIVE_BACKEND
    if name not in BACKEND_NAMES:
        raise ValueError(f"unknown backend {name!r}; registered: {BACKEND_NAMES}")
    _ACTIVE_BACKEND = name


def get_backend() -> str:
    return _ACTIVE_BACKEND


@contextlib.contextmanager
def use_backend(name: str):
    """Within the block, new FieldElement and Scalar values use ``name``."""
    saved = get_backend()
    set_backend(name)
    try:
        yield
    finally:
        set_backend(saved)


_DEFAULT_DEVICE: torch.device | None = None


def default_device() -> torch.device:
    """The device that constructors use when given none: the one set by
    ``set_default_device`` or ``use_device``, else the first CUDA card.
    Raises where no device was set and there is no CUDA card."""
    if _DEFAULT_DEVICE is not None:
        return _DEFAULT_DEVICE
    if not torch.cuda.is_available():
        raise RuntimeError("zerocaf_tpu_torch places tensors on the first CUDA "
                           "card by default and none is available; pass "
                           "device='cpu', or call "
                           "zerocaf_tpu_torch.config.set_default_device('cpu') "
                           "(or use `with use_device('cpu'):`) to run on the CPU")
    return torch.device("cuda", 0)


def set_default_device(device) -> None:
    """Set the device that constructors use when given none; None restores
    the first CUDA card."""
    global _DEFAULT_DEVICE
    _DEFAULT_DEVICE = None if device is None else torch.device(device)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device, or ``default_device()`` for None."""
    return default_device() if device is None else torch.device(device)


@contextlib.contextmanager
def use_device(device):
    """Within the block, constructors given no device use ``device``."""
    global _DEFAULT_DEVICE
    saved = _DEFAULT_DEVICE
    set_default_device(device)
    try:
        yield
    finally:
        _DEFAULT_DEVICE = saved
