"""Serving-shape API: pinned batch, wire in, wire out
(zerocaf_tpu/serving.py counterpart).

An ``Engine`` serves fixed-size batches of 32-byte wire arrays on one
device, the first CUDA card unless told otherwise.  Ragged traffic is padded
to the engine batch with ``pad_batch`` (``pad_msm`` for MSM requests).  The
port serves the JAX package's four workloads: ``keygen`` (fixed-base comb),
``dh``, ``hash_to_group`` and ``msm``; the pipelined wrapper is a later
slice (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from .models import ristretto as _ri
from .models.edwards import EdwardsPoint
from .parallel.msm import msm as _msm
from .scalar import Scalar


def pad_batch(arr: np.ndarray, batch: int):
    """Pad axis 0 with zeros up to ``batch``; returns (padded, n_valid)."""
    n = arr.shape[0]
    if n > batch:
        raise ValueError(f"batch {n} exceeds engine batch {batch}")
    if n == batch:
        return arr, n
    pad = np.zeros((batch - n,) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad], axis=0), n


def pad_msm(points_wire: np.ndarray, scalar32: np.ndarray, batch: int):
    """Pad an MSM request to the engine batch with identity wire (32 zero
    bytes, the canonical Ristretto identity) and zero scalars, which add
    nothing to the aggregate.  Returns (points, scalars, n_valid)."""
    p, n = pad_batch(points_wire, batch)
    s, _ = pad_batch(scalar32, batch)
    return p, s, n


class Engine:
    """Pinned-batch serving engine on one device: keygen, dh, hash_to_group
    and msm.  Secret scalars go through oblivious kernels, except in keygen,
    whose fixed-base comb loads its table at the secret digit (see
    ``keygen``).

    batch:  lanes per call (pad ragged requests with pad_batch).  32768 is
            the JAX package's default; on the H100 it is the keygen and
            ECDH serving size that chip_smoke.py drives.
    device: where the wire arrays are computed; inputs are moved there.
            None means the first CUDA card, and raises where there is
            none; pass "cpu" to run the kernels' plain versions.
    donate: accepted for the JAX package's signature, where it donates
            the input buffers to its compiled calls; it has no effect here
            (PyTorch runs eagerly and compiles nothing).
    """

    def __init__(self, batch: int = 32768, device=None, donate: bool = True):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("Engine() serves on the first CUDA card and "
                                   "none is available; pass device='cpu' to "
                                   "run on the CPU")
            device = "cuda:0"
        self.batch = batch
        self.device = torch.device(device)

    def _wire(self, arr, width: int) -> torch.Tensor:
        t = torch.as_tensor(arr, dtype=torch.uint8).to(self.device)
        if tuple(t.shape) != (self.batch, width):
            raise ValueError(f"expected [{self.batch}, {width}] uint8, got "
                             f"{tuple(t.shape)}; pad with pad_batch or pad_msm")
        return t.contiguous()

    def keygen(self, seed64):
        """[batch, 64] uniform seed bytes -> (sk [batch, 32], pk [batch, 32]).

        sk is the canonical encoding of the wide-reduced seed; pk the
        Ristretto wire of sk * B by the fixed-base comb (K6, the signed
        width-14 comb on the packed table).  The comb is the one served
        path whose table load is indexed by a secret digit: it is not
        oblivious at cache-line granularity, as in the reference and the
        JAX package (docs/CONSTANT_TIME.md)."""
        sk = Scalar.from_bytes_wide(self._wire(seed64, 64))
        pk = _ri._compress(EdwardsPoint.basepoint_mul(sk)._tuple())
        return sk.to_bytes(), pk

    def dh(self, sk32, peer32):
        """[batch, 32] secret scalar bytes + [batch, 32] peer Ristretto wire
        -> ([batch, 32] shared wire, ok).  ok is False for invalid peer
        encodings (those lanes hold garbage).

        The secret multiply is the signed windowed kernel (K4): its one-hot
        table read touches every entry for every lane, so the access
        pattern does not depend on the secret; it never goes through a
        gather.  Non-canonical secrets are reduced mod r, as in the JAX
        package."""
        s, _ = Scalar.from_bytes(self._wire(sk32, 32))
        p, ok = _ri._decompress(self._wire(peer32, 32))
        q = EdwardsPoint(*p).mul_windowed(s)
        return _ri._compress(q._tuple()), ok

    def hash_to_group(self, uniform64):
        """[batch, 64] uniform bytes -> [batch, 32] Ristretto wire."""
        p = _ri.RistrettoPoint.from_uniform_bytes(self._wire(uniform64, 64))
        return p.compress()

    def msm(self, points_wire, scalar32, c: int | None = None,
            dense: bool | None = None):
        """[batch, 32] Ristretto wire + [batch, 32] scalar bytes ->
        ([32] wire of sum(s_i * P_i), ok).

        ok is False if any lane's point encoding is invalid: the aggregate
        is then garbage and the caller must reject the whole batch, as a
        verifier does.  Scalars are reduced mod r.  The batch axis must
        equal the engine batch (``pad_msm`` pads with identity points and
        zero scalars).  c and dense choose the window width and the route
        of ``parallel.msm.msm``: by default the dense kernels (K7, K5, K8)
        at c = 6."""
        pts, ok = _ri._decompress(self._wire(points_wire, 32))
        s, _ = Scalar.from_bytes(self._wire(scalar32, 32))
        total = _msm(EdwardsPoint(*pts), s, c=c, dense=dense)
        return _ri._compress(total._tuple()), ok.all()
