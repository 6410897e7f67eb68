"""The one traffic generator: a cell's inputs and the reference's answers,
made from the seed.

A traffic mix is a JSON file of parameters (``mixes/<name>.json``); a
configuration is a JSON file of sizes (``configs/<name>.json``).  This
module reads both and makes, with the plain reference alone:

* a pool of distinct group elements P_j = k_j B whose discrete logs k_j the
  reference knows, since it made them (k_j = a + j b mod r, a and b drawn
  from the seed), and their Ristretto encodings;
* ``batches`` input batches of the configuration's ``batch`` lanes: for
  ``msm`` pool points picked by seeded indices and scalars uniform in
  [0, r) (``uniform_scalars``); for ``dh`` such secrets and peers from the pool, one
  lane in ``invalid_every`` an invalid encoding (a non-canonical field
  element or a non-square); for ``keygen`` and ``hash_to_group`` uniform
  64-byte strings;
* the reference's answer to each: the MSM's encoding, from
  (sum_i s_i k_idx(i) mod r) B, and lane by lane the shared secret
  (s k_j mod r) B, the key pair, or the hashed point.

Every seed gives the same sizes; only the values and their order change.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .reference import curve as ref

OPS = ("msm", "dh", "keygen", "hash_to_group")
PATHS = ("wire", "resident")


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one use of a seed; any whole number is a seed."""
    return np.random.default_rng(np.random.SeedSequence([seed % 2**64, *stream]))


def uniform_scalars(rng: np.random.Generator, n: int) -> np.ndarray:
    """[n, 32] uint8 encodings of scalars uniform in [0, 2^249).  Since
    r = 2^249 + d with d < 2^125, that is uniform in [0, r) but for a
    share below 2^-124 of the draws."""
    b = np.frombuffer(rng.bytes(32 * n), np.uint8).reshape(n, 32).copy()
    b[:, 31] &= 0x01
    return b


@dataclasses.dataclass
class Pool:
    """Distinct group elements with their discrete logs and encodings."""

    logs: list[int]
    wire: np.ndarray            # [size, 32] uint8
    invalid: np.ndarray         # [m, 32] uint8, invalid encodings

    @classmethod
    def make(cls, rng: np.random.Generator, size: int, table, n_invalid: int):
        a, b = (int.from_bytes(rng.bytes(40), "little") % (ref.R - 1) + 1
                for _ in range(2))
        logs = [(a + j * b) % ref.R for j in range(size)]
        step = table.mul(b)
        pt = table.mul(a)
        wire = []
        for _ in range(size):
            wire.append(ref.ristretto_compress(pt))
            pt = ref.point_add(pt, step)
        if len(set(wire)) != size:
            raise ValueError("pool points are not distinct")
        invalid = []
        for j in range(n_invalid // 2):            # s + p: not canonical
            s = int.from_bytes(wire[j % size], "little")
            invalid.append((s + ref.P).to_bytes(32, "little"))
        while len(invalid) < n_invalid:            # positive, canonical, off the group
            s = int.from_bytes(rng.bytes(32), "little") % ((ref.P + 1) // 2)
            enc = ref.fe_to_bytes(s)
            if ref.ristretto_decompress(enc) is None:
                invalid.append(enc)
        as_array = (lambda rows: np.frombuffer(b"".join(rows), np.uint8)
                    .reshape(-1, 32).copy())
        return cls(logs, as_array(wire), as_array(invalid) if invalid
                   else np.zeros((0, 32), np.uint8))


@dataclasses.dataclass
class Batch:
    """One batch of host inputs (the arguments of the op, in order) and
    what the reference needs to judge its answer."""

    args: tuple
    idx: np.ndarray | None = None        # pool index of each lane's point
    ok: np.ndarray | None = None         # [batch] the decode's expected mask


class Traffic:
    """A cell's inputs and the reference's answers.

    config: the configuration's parameters (``batch``, ``pool``, ...);
    mix: the traffic mix's (``op``, ``path``, ``batches``, ``invalid_every``,
    ``check_lanes``)."""

    def __init__(self, config: dict, mix: dict, seed: int):
        self.op = mix["op"]
        self.path = mix.get("path", "wire")
        if self.op not in OPS or self.path not in PATHS:
            raise ValueError(f"unknown op {self.op!r} or path {self.path!r}")
        if self.path == "resident" and self.op != "msm":
            raise ValueError("the resident path serves msm only")
        self.seed = seed
        self.batch = int(config["batch"])
        self.check_lanes = int(mix.get("check_lanes", 32))
        invalid_every = int(mix.get("invalid_every", 0))
        rng = rng_for(seed, 0)
        self.table = ref.BasepointTable()
        self.pool = Pool.make(rng, int(config.get("pool", 4096)), self.table,
                              256 if invalid_every else 0)
        n = self.batch
        fixed_idx = (rng.integers(0, len(self.pool.logs), n)
                     if self.path == "resident" else None)
        self.bases = None if fixed_idx is None else self.pool.wire[fixed_idx]
        self.batches: list[Batch] = []
        for _ in range(int(mix.get("batches", 4))):
            if self.op == "msm":
                idx = fixed_idx if fixed_idx is not None else rng.integers(
                    0, len(self.pool.logs), n)
                s = uniform_scalars(rng, n)
                args = (s,) if self.path == "resident" else (self.pool.wire[idx], s)
                self.batches.append(Batch(args, idx))
            elif self.op == "dh":
                idx = rng.integers(0, len(self.pool.logs), n)
                peers = self.pool.wire[idx]
                ok = np.ones(n, bool)
                if invalid_every:
                    bad = rng.choice(n, n // invalid_every, replace=False)
                    peers[bad] = self.pool.invalid[
                        rng.integers(0, len(self.pool.invalid), len(bad))]
                    ok[bad] = False
                self.batches.append(Batch((uniform_scalars(rng, n), peers), idx, ok))
            else:
                self.batches.append(Batch((np.frombuffer(
                    rng.bytes(64 * n), np.uint8).reshape(n, 64).copy(),)))
        self._aggregates: dict[int, bytes] = {}

    def sample_lanes(self, call: int) -> np.ndarray:
        """The lanes of call ``call`` whose answers are compared, drawn from
        the seed: all of them where the batch is no larger than the count."""
        if self.op == "msm" or self.batch <= self.check_lanes:
            return np.arange(self.batch if self.op != "msm" else 0)
        return np.sort(rng_for(self.seed, 1, call).choice(
            self.batch, self.check_lanes, replace=False))

    # -- the reference's answers ---------------------------------------------

    def aggregate(self, i: int) -> bytes:
        """Batch i's MSM, encoded: (sum_i s_i k_idx(i) mod r) B.  The
        scalars are summed per pool point in 16-bit limbs (exact in
        float64: at most 2^16 * 2^20 per limb sum), then weighted by the
        points' logs."""
        if i not in self._aggregates:
            b = self.batches[i]
            s = b.args[-1]
            limbs = np.ascontiguousarray(s).view("<u2")         # [n, 16]
            size = len(self.pool.logs)
            sums = np.stack([np.bincount(b.idx, weights=limbs[:, k], minlength=size)
                             for k in range(16)], axis=1)
            t = 0
            for log, row in zip(self.pool.logs, sums.astype(np.int64).tolist()):
                if any(row):
                    t += log * sum(v << (16 * k) for k, v in enumerate(row))
            self._aggregates[i] = ref.ristretto_compress(self.table.mul(t % ref.R))
        return self._aggregates[i]

    def lane_answer(self, i: int, lane: int) -> tuple[bytes, ...]:
        """The reference's answer for one lane of batch i: (shared,) for
        dh, (sk, pk) for keygen, (point,) for hash_to_group."""
        b = self.batches[i]
        if self.op == "dh":
            s = int.from_bytes(b.args[0][lane].tobytes(), "little")
            k = s * self.pool.logs[int(b.idx[lane])] % ref.R
            return (ref.ristretto_compress(self.table.mul(k)),)
        if self.op == "keygen":
            sk = ref.scalar_from_bytes_wide(b.args[0][lane].tobytes())
            return (sk.to_bytes(32, "little"),
                    ref.ristretto_compress(self.table.mul(sk)))
        if self.op == "hash_to_group":
            return (ref.ristretto_compress(
                ref.from_uniform_bytes(b.args[0][lane].tobytes())),)
        raise ValueError(f"{self.op} has no lane answers")
