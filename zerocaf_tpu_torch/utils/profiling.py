"""Profiling and roofline accounting (zerocaf_tpu/utils/profiling.py
counterpart): a ``torch.profiler`` trace, a timer that waits for the card,
and the static cost model that ``chip_smoke.py`` prices its bounds with.

The cost model describes the port's kernels.  Every kernel computes on the
8 x 32-bit Montgomery core of ``csrc/field32.cuh``: one field multiply is
64 word products (32 x 32 -> 64 bits) and 8 reduction steps of 5 (m =
t0 (-p^-1) and m times p's four nonzero low words), 104 in all; a square is
28 cross products, 8 squares and the same reduction, 76.  Only products
count: the adds and carries ride in the multiply-adds.  At the tensor
boundary an element is 22 int32 limbs, 88 bytes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch

# Word products of one field multiply and one square on the 8 x 32 core.
OPS_8X32 = (8 * 8 + 8 * 5, 28 + 8 + 8 * 5)
LIMB_BYTES = 22 * 4                 # one element at the tensor boundary
POINT_BYTES = 4 * LIMB_BYTES        # one extended point (X, Y, Z, T)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the block: CPU activity, and
    the card's kernels where CUDA is available.  On exit the Chrome trace
    is written into ``logdir`` (``<host>.<pid>.<ms>.pt.trace.json``,
    TensorBoard's naming) and its path set as the profile's
    ``trace_path``.  Yields the profile (``key_averages()`` reads it)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        _synchronize_all()
    path = os.path.join(logdir, f"{os.uname().nodename}.{os.getpid()}."
                                f"{int(time.time() * 1e3)}.pt.trace.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path


SPAN_PREFIX = "zc."


def span(name: str):
    """A ``torch.profiler.record_function`` range named ``zc.<name>``
    around one stage of a call, for a trace to time and count by stage.
    The name is fixed by the call site (never built from data), and the
    range neither waits for the card nor records its inputs; with no
    profiler running an enter and exit cost about 11 us of host time
    (H100 machine, PyTorch 2.11)."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def _synchronize_all() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _cuda_devices(out, found: set) -> set:
    """The CUDA devices of the tensors in ``out`` (a tensor, or tuples,
    lists, dicts and dataclasses of them)."""
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            found.add(out.device)
    elif isinstance(out, (tuple, list)):
        for o in out:
            _cuda_devices(o, found)
    elif isinstance(out, dict):
        for o in out.values():
            _cuda_devices(o, found)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            _cuda_devices(getattr(out, f.name), found)
    return found


def _wait(out) -> None:
    """Wait until the card has computed ``out``."""
    for dev in _cuda_devices(out, set()):
        torch.cuda.synchronize(dev)


def timeit(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median wall time of one call fn(*args) in seconds, each call ended
    by a ``torch.cuda.synchronize`` on its output's devices."""
    for _ in range(warmup):
        _wait(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _wait(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """Static per-element cost model of a batched kernel (roofline notes):
    its word products on the 8 x 32 core and the bytes it reads and writes
    at the tensor boundary."""

    name: str
    int_ops: int        # 32 x 32 -> 64-bit word products per batch element
    bytes_moved: int    # bytes read and written per batch element

    @property
    def arithmetic_intensity(self) -> float:
        return self.int_ops / max(self.bytes_moved, 1)


MUL, SQ = OPS_8X32
# K1: two operands in, one product out.
FIELD_MUL = KernelCost("field_mul", int_ops=MUL, bytes_moved=3 * LIMB_BYTES)
# An addition or subtraction: limb adds and carries, no word product.
FIELD_ADD = KernelCost("field_add", int_ops=0, bytes_moved=3 * LIMB_BYTES)
FIELD_SQUARE = KernelCost("field_square", int_ops=SQ, bytes_moved=2 * LIMB_BYTES)
# K5: padd_ext, 10 multiplies; two points in, one out.
POINT_ADD = KernelCost("point_add", int_ops=10 * MUL, bytes_moved=3 * POINT_BYTES)
# dbl-2008-hwcd with T: 4 squares and 4 multiplies.
POINT_DOUBLE = KernelCost("point_double", int_ops=4 * SQ + 4 * MUL,
                          bytes_moved=2 * POINT_BYTES)
# K3 at width 1: the Niels entry (one multiply), then 250 steps of a
# doubling with T and a Niels addition (8 multiplies); the point in and
# out and 250 int32 bits stay the only traffic.
SCALAR_MUL = KernelCost("scalar_mul_ladder",
                        int_ops=MUL + 250 * (POINT_DOUBLE.int_ops + 8 * MUL),
                        bytes_moved=2 * POINT_BYTES + 4 * 250)


def report(costs=(FIELD_MUL, FIELD_ADD, FIELD_SQUARE, POINT_ADD, POINT_DOUBLE,
                  SCALAR_MUL)):
    lines = ["kernel               int_ops/elem  bytes/elem  intensity(op/B)"]
    for c in costs:
        lines.append(f"{c.name:20s} {c.int_ops:12d} {c.bytes_moved:11d} "
                     f"{c.arithmetic_intensity:10.1f}")
    return "\n".join(lines)
