"""Collectives over the mesh axis (zerocaf_tpu/parallel/comm.py
counterpart): the one place that touches ``torch.distributed``.

Elliptic-curve addition is not an operation a collective can reduce with,
so cross-rank point reductions are an ``all_gather`` of the ranks' partial
points (352 bytes each; one rank's bucket tables are nwin * nb * 352
bytes, 0.49 MB at c = 6) followed by a local tree reduction on the card
(parallel/msm.py).  On a one-rank mesh without a process group every
collective is the local identity.

NCCL takes the CUDA tensors as they are.  Gloo's point-to-point and some
of its collectives take host tensors only, so on a gloo group a CUDA
payload is copied to the host, exchanged, and copied back
(``_host_staged``); the EC work stays on the card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Mesh


class Communicator:
    """Collectives of one rank over a mesh axis."""

    def __init__(self, mesh: Mesh, axis: str = "data"):
        if axis != mesh.axis:
            raise ValueError(f"Communicator: axis {axis!r}, mesh axis {mesh.axis!r}")
        self.mesh = mesh
        self.axis = axis
        self._host_staged = (mesh.group is not None
                             and dist.get_backend(mesh.group) == "gloo")

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """x as the backend takes it: contiguous, on the host for gloo."""
        x = x.contiguous()
        return x.cpu() if self._host_staged else x

    def axis_index(self) -> int:
        return self.mesh.rank

    def axis_size(self) -> int:
        return self.mesh.size

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks (integer or float)."""
        if self.mesh.group is None:
            return x
        y = self._wire(x).clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.mesh.group)
        return y.to(x.device)

    def all_gather(self, x: torch.Tensor, axis: int = 0,
                   tiled: bool = False) -> torch.Tensor:
        """Every rank's x: stacked on a new axis ``axis`` (rank order), or
        concatenated along it when tiled."""
        if self.mesh.group is None:
            return x if tiled else x.unsqueeze(axis)
        y = self._wire(x)
        parts = [torch.empty_like(y) for _ in range(self.mesh.size)]
        dist.all_gather(parts, y, group=self.mesh.group)
        out = torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)
        return out.to(x.device)

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """Send x along the (source, destination) pairs of perm; a rank no
        pair sends to gets zeros."""
        me = self.mesh.rank
        dst = [d for s, d in perm if s == me]
        src = [s for s, d in perm if d == me]
        if len(dst) > 1 or len(src) > 1:
            raise ValueError(f"ppermute: rank {me} appears twice in {perm}")
        if self.mesh.group is None or (dst == [me] and src == [me]):
            return x.clone() if src == [me] else torch.zeros_like(x)
        y = self._wire(x)
        out = torch.zeros_like(y)
        # P2POp takes global ranks as peers.  A mesh is ranks 0..size-1 of
        # the world (make_mesh), so its group ranks are the global ones.
        ops = [dist.P2POp(dist.isend, y, d, group=self.mesh.group) for d in dst]
        ops += [dist.P2POp(dist.irecv, out, s, group=self.mesh.group) for s in src]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out.to(x.device)

    def all_gather_points(self, point_tuple):
        """Every rank's extended points in one collective: each [..., 22]
        coordinate becomes [ndev, ..., 22]."""
        return tuple(self.all_gather(torch.stack(point_tuple)).unbind(1))
