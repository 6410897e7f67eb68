"""Serving-shape API: pinned batch, wire in, wire out
(zerocaf_tpu/serving.py counterpart).

An ``Engine`` serves fixed-size batches of 32-byte wire arrays on one
device, the first CUDA card unless told otherwise.  Ragged traffic is padded
to the engine batch with ``pad_batch`` (``pad_msm`` for MSM requests).  The
port serves the JAX package's four workloads: ``keygen`` (fixed-base comb),
``dh``, ``hash_to_group`` and ``msm``.  ``Engine.pipeline`` keeps up to
``depth`` calls in flight: on a CUDA engine each call runs on the
pipeline's own stream from pinned host buffers, so the upload, compute and
download of one batch can overlap the host's work on the next (a
host-bound call gains nothing from it; PERF.md).
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from .models import ristretto as _ri
from .models.edwards import EdwardsPoint
from .parallel.msm import _use_dense, auto_c, auto_c_dense
from .parallel.msm import msm as _msm
from .ops.limb import SCALAR as _S
from .scalar import Scalar
from .utils import profiling as _prof


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
        self._served: set[str] = set()

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
        JAX package (docs/CONSTANT_TIME.md).  Spans:
        ``zc.keygen.reduce_wide``, the comb's two (``basepoint_mul``),
        ``zc.keygen.encode``."""
        self._served.add("keygen")
        seed = self._wire(seed64, 64)
        with _prof.span("keygen.reduce_wide"):
            sk = Scalar.from_bytes_wide(seed, _S)
        point = EdwardsPoint.basepoint_mul(sk)
        with _prof.span("keygen.encode"):
            pk = _ri._compress(point._tuple())
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
        self._served.add("dh")
        s, _ = Scalar.from_bytes(self._wire(sk32, 32), _S)
        p, ok = _ri._decompress(self._wire(peer32, 32))
        q = EdwardsPoint(*p).mul_windowed(s)
        return _ri._compress(q._tuple()), ok

    def hash_to_group(self, uniform64):
        """[batch, 64] uniform bytes -> [batch, 32] Ristretto wire."""
        self._served.add("hash_to_group")
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
        s, _ = Scalar.from_bytes(self._wire(scalar32, 32), _S)
        if _use_dense(self.batch, c, dense):
            c, dense = (c if c is not None else auto_c_dense(self.batch)), True
            self._served.add(f"msm_dense_c{c}")
        else:
            c, dense = (c if c is not None else auto_c(self.batch)), False
            self._served.update((f"msm_decode_c{c}", f"msm_encode_c{c}"))
        total = _msm(EdwardsPoint(*pts), s, c=c, dense=dense)
        return _ri._compress(total._tuple()), ok.all()

    # -- pipelined serving -----------------------------------------------------

    def pipeline(self, name: str, depth: int = 2) -> "Pipeline":
        """A ``Pipeline`` around one op ("keygen", "dh", "hash_to_group",
        "msm") with up to ``depth`` calls in flight."""
        return Pipeline(getattr(self, name), depth)

    def compiled(self) -> list[str]:
        """The JAX package's names of the pipelines that this engine has
        served, sorted: "keygen", "dh", "hash_to_group", and
        "msm_dense_c{c}" or "msm_decode_c{c}" and "msm_encode_c{c}" for
        each MSM route and width.  PyTorch compiles nothing; the names say
        which calls ran, as the JAX package's compiled graphs do."""
        return sorted(self._served)


class _Slot:
    """One in-flight call's pinned host buffers and its completion event."""

    def __init__(self):
        self.inputs: dict[int, torch.Tensor] = {}
        self.outputs: list[torch.Tensor] = []
        self.event = torch.cuda.Event()
        self.tuple_out = False

    def stage_in(self, i: int, arg) -> torch.Tensor:
        """Copy a host argument into this slot's pinned buffer ``i``."""
        src = torch.as_tensor(arg)
        buf = self.inputs.get(i)
        if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
            buf = self.inputs[i] = torch.empty(src.shape, dtype=src.dtype,
                                               pin_memory=True)
        buf.copy_(src)
        return buf

    def stage_out(self, outs) -> None:
        """Enqueue the copies of the call's device outputs into this slot's
        pinned buffers (on the current stream)."""
        if [(b.shape, b.dtype) for b in self.outputs] != [(o.shape, o.dtype)
                                                          for o in outs]:
            self.outputs = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                            for o in outs]
        for buf, o in zip(self.outputs, outs):
            buf.copy_(o, non_blocking=True)


class Pipeline:
    """Keeps up to ``depth`` calls of one Engine op in flight.  Results come
    back in submission order as host numpy arrays, equal byte for byte to
    the op's sequential calls.

    On a CUDA engine the calls run on the pipeline's own stream: each of
    the ``depth`` slots stages its host inputs in pinned buffers, uploads
    them without blocking, runs the op on device tensors, copies the
    outputs into pinned buffers and records an event, which ``collect``
    waits on.  CUDA tensor arguments are passed on as they are.  The
    pipeline's stream waits for the caller's current stream at creation,
    and the caller's stream for the pipeline's once it is empty, so tables
    and constants that the op caches on the device at first use are
    complete before either stream reads them.  On a CPU engine the calls
    run one after another.

        pipe = engine.pipeline("dh", depth=2)
        for sk, peer in traffic:
            done = pipe.submit(sk, peer)      # the oldest result, or None
            if done is not None:
                emit(done)
        for done in pipe.drain():
            emit(done)
    """

    def __init__(self, call, depth: int = 2):
        """call: a bound method of an ``Engine``, whose device it runs on."""
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self._call = call
        self.depth = depth
        self.device = call.__self__.device
        self._inflight: deque = deque()
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            self._slots = [_Slot() for _ in range(depth)]
            self._next = 0

    def _launch(self, args, kwargs):
        slot = self._slots[self._next % self.depth]
        self._next += 1
        caller = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._stream):
            dev_args = []
            for i, a in enumerate(args):
                if isinstance(a, torch.Tensor) and a.device.type == "cuda":
                    self._stream.wait_stream(caller)
                    a.record_stream(self._stream)
                    dev_args.append(a)
                else:
                    dev_args.append(slot.stage_in(i, a).to(self.device,
                                                           non_blocking=True))
            out = self._call(*dev_args, **kwargs)
            slot.tuple_out = isinstance(out, tuple)
            slot.stage_out(out if slot.tuple_out else (out,))
            slot.event.record(self._stream)
        return slot

    def _pop(self):
        entry = self._inflight.popleft()
        if self._stream is None:                   # a CPU call's result
            if isinstance(entry, tuple):
                return tuple(o.numpy() for o in entry)
            return entry.numpy()
        entry.event.synchronize()
        if not self._inflight:
            torch.cuda.current_stream(self.device).wait_stream(self._stream)
        host = tuple(b.numpy().copy() for b in entry.outputs)
        return host if entry.tuple_out else host[0]

    def submit(self, *args, **kwargs):
        """Start one call.  If ``depth`` calls were already in flight, first
        waits for the oldest and returns its result; otherwise returns None
        (the pipeline is still filling)."""
        out = self.collect() if len(self._inflight) >= self.depth else None
        self._inflight.append(self._call(*args, **kwargs) if self._stream is None
                              else self._launch(args, kwargs))
        return out

    def collect(self):
        """Wait for the oldest call in flight and return its result."""
        if not self._inflight:
            raise RuntimeError("pipeline is empty: nothing submitted")
        return self._pop()

    def drain(self):
        """Every remaining result, oldest first."""
        out = []
        while self._inflight:
            out.append(self._pop())
        return out

    def map(self, batches):
        """Generator: feed an iterable of argument tuples through the
        pipeline, yielding the results in order with ``depth`` in flight."""
        for args in batches:
            done = self.submit(*args)
            if done is not None:
                yield done
        yield from self.drain()

    def __len__(self):
        return len(self._inflight)
