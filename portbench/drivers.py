"""The system under test, driven: the entries that a cell's window calls.

This is the one module of the benchmark that imports the program
(``zerocaf_tpu_torch``), and it takes from it only the entries, their
launch counters and the route they report.  Each driver has

    dispatch(i, args=None) -> device outputs of one call on batch i
    fetch(outputs)         -> the outputs as host numpy arrays (rank 0),
                              or None after waiting for the card (others)

and a call is ``fetch(dispatch(i))``: host bytes in, host bytes out.
"""

from __future__ import annotations

import importlib
import re
from pathlib import Path

import numpy as np
import torch

import zerocaf_tpu_torch as zc
from zerocaf_tpu_torch.config import MeshConfig
from zerocaf_tpu_torch.parallel import make_mesh

# the module (the package's ``msm`` attribute is the function)
_MSM = importlib.import_module("zerocaf_tpu_torch.parallel.msm")


def _host(outputs) -> tuple[np.ndarray, ...]:
    return tuple(o.cpu().numpy() for o in outputs)


class EngineDriver:
    """One ``Engine`` op on host bytes: the wire path."""

    def __init__(self, traffic, route: dict, device):
        self.traffic = traffic
        self.engine = zc.Engine(batch=traffic.batch, device=device)
        self.fn = getattr(self.engine, traffic.op)
        self.kwargs = ({k: route.get(k) for k in ("c", "dense")}
                       if traffic.op == "msm" else {})

    def dispatch(self, i: int, args=None):
        out = self.fn(*(args or self.traffic.batches[i].args), **self.kwargs)
        return out if isinstance(out, tuple) else (out,)

    def fetch(self, outputs):
        return _host(outputs)

    def window_bits(self) -> int | None:
        """The window width of the MSM route the engine ran, as it names
        it (``Engine.compiled``)."""
        for name in self.engine.compiled():
            if name.startswith("msm_dense_c"):
                return int(name[len("msm_dense_c"):])
        return None


class ResidentDriver:
    """The MSM on bases decoded once at set-up and kept on the card: each
    call uploads its scalars, reduces them (``Scalar.from_bytes``), runs
    ``msm`` (one rank) or ``msm_sharded`` over the mesh, and rank 0 encodes
    the sum.  Each rank holds its block of the batch."""

    def __init__(self, traffic, route: dict, device, rank: int = 0,
                 world: int = 1):
        self.traffic, self.route, self.rank, self.world = traffic, route, rank, world
        self.device = torch.device(device)
        block = traffic.batch // world
        self.rows = slice(rank * block, (rank + 1) * block)
        self.mesh = (make_mesh(MeshConfig(n_devices=world), devices=self.device)
                     if world > 1 else None)
        wire = torch.from_numpy(traffic.bases[self.rows]).to(self.device)
        points, ok = zc.RistrettoPoint.decompress(wire)
        if not bool(ok.all()):
            raise RuntimeError("a resident base failed to decode")
        self.points = points.point

    def dispatch(self, i: int, args=None):
        scalars = (args or self.traffic.batches[i].args)[0][self.rows]
        s, _ = zc.Scalar.from_bytes(torch.from_numpy(scalars).to(self.device))
        if self.mesh is None:
            total = zc.msm(self.points, s, c=self.route.get("c"),
                           dense=self.route.get("dense"))
        else:
            total = zc.msm_sharded(self.points, s, self.mesh,
                                   c=self.route.get("c"),
                                   dense=bool(self.route.get("dense")),
                                   shard_combine=bool(self.route.get("shard_combine")))
        if self.rank:
            return (total.X,)
        return (zc.RistrettoPoint(total).compress(),)

    def fetch(self, outputs):
        if self.rank:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return None
        return _host(outputs)

    def window_bits(self) -> int | None:
        """The width the program picks for this batch on the dense route
        (None where the route is another)."""
        c = self.route.get("c")
        if self.route.get("dense") is False:
            return None
        return c if c is not None else _MSM.auto_c_dense(self.traffic.batch)


def open_driver(traffic, route: dict, device, rank: int = 0, world: int = 1):
    if traffic.path == "resident":
        return ResidentDriver(traffic, route, device, rank, world)
    if world != 1:
        raise ValueError("the wire path serves from one rank")
    return EngineDriver(traffic, route, device)


def port_kernel_names() -> list[str]:
    """The program's own CUDA kernels: the ``__global__`` functions of its
    ``csrc/*.cu`` sources, read from the sources."""
    names = set()
    for src in (Path(zc.__file__).parent / "csrc").glob("*.cu"):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
            src.read_text()))
    return sorted(names)


def build_kernels() -> float:
    """Build the program's kernel libraries if this checkout has not, and
    return the seconds that took (0 when they were built)."""
    from zerocaf_tpu_torch.ops.kernels import build
    return build.build()[1]
