"""The comparison's control: the plain reference put in the program's place
with one of the configuration's guarantees broken, judged by the same
comparison as a run.  Each control must come out not correct.

    python3 -m portbench.control --workload <cell> --seed <n> --calls <k> \
        --variant <edwards_encoding|lenient_decode>

The cell's traffic is made at its own size; the control answers exactly
what a run of k calls would have its answers compared on (the same batches
in turn, the same lanes drawn from the seed, every ok flag), and the
numbers compared are printed with their limits.

    edwards_encoding  every answer encoded as the Edwards y-coordinate with
                      the sign of x (the step that skips the Ristretto
                      encoding's inverse square root), not as Ristretto
    lenient_decode    the decode reduces a non-canonical field encoding
                      mod p instead of refusing it (dh only)

The control runs no program code and needs no card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from . import judge
from .reference import curve as ref
from .spec import Benchmark
from .traffic import Traffic

VARIANTS = ("edwards_encoding", "lenient_decode")


def edwards_encoding(p) -> bytes:
    """The affine y with the low bit of x in the top bit."""
    X, Y, Z, _ = p
    zi = ref.finv(Z)
    x, y = X * zi % ref.P, Y * zi % ref.P
    b = bytearray(ref.fe_to_bytes(y))
    b[31] |= (x & 1) << 7
    return bytes(b)


def lenient_ok(wire: bytes) -> bool:
    """The decode's ok flag when non-canonical encodings are reduced mod p
    rather than refused."""
    s = int.from_bytes(wire, "little") % ref.P
    return ref.ristretto_decompress(ref.fe_to_bytes(s)) is not None


def _point(traffic: Traffic, batch: int, lane: int):
    b = traffic.batches[batch]
    if traffic.op == "dh":
        s = int.from_bytes(b.args[0][lane].tobytes(), "little")
        return traffic.table.mul(s * traffic.pool.logs[int(b.idx[lane])] % ref.R)
    if traffic.op == "keygen":
        return traffic.table.mul(ref.scalar_from_bytes_wide(b.args[0][lane].tobytes()))
    return ref.from_uniform_bytes(b.args[0][lane].tobytes())


def control_outputs(traffic: Traffic, call: int, batch: int, variant: str,
                    masks: dict):
    """One call's host outputs as the control computes them: only what the
    comparison reads is filled in.  masks keeps each batch's ok mask."""
    encode = edwards_encoding if variant == "edwards_encoding" else ref.ristretto_compress
    if traffic.op == "msm":
        wire = traffic.aggregate(batch)
        if variant == "edwards_encoding":
            wire = encode(ref.ristretto_decompress(wire))
        return (np.frombuffer(wire, np.uint8), np.array(True))
    n = traffic.batch
    out = np.zeros((n, 32), np.uint8)
    sk = np.zeros((n, 32), np.uint8)
    for lane in traffic.sample_lanes(call).tolist():
        out[lane] = np.frombuffer(encode(_point(traffic, batch, lane)), np.uint8)
        if traffic.op == "keygen":
            sk[lane] = np.frombuffer(ref.scalar_from_bytes_wide(
                traffic.batches[batch].args[0][lane].tobytes()).to_bytes(32, "little"),
                np.uint8)
    if traffic.op == "keygen":
        return (sk, out)
    if traffic.op != "dh":
        return (out,)
    if batch not in masks:
        ok = traffic.batches[batch].ok.copy()
        if variant == "lenient_decode":
            peers = traffic.batches[batch].args[1]
            for lane in np.flatnonzero(~ok).tolist():
                ok[lane] = lenient_ok(peers[lane].tobytes())
        masks[batch] = ok
    return (out, masks[batch])


def run_control(traffic: Traffic, calls: int, variant: str) -> dict:
    if variant not in VARIANTS:
        raise ValueError(f"unknown control {variant!r}")
    records, masks = [], {}
    for call in range(calls):
        batch = call % len(traffic.batches)
        host = control_outputs(traffic, call, batch, variant, masks)
        records.append(judge.capture(traffic, call, batch, host))
    return judge.judge(traffic, records)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, required=True)
    ap.add_argument("--variant", choices=VARIANTS, required=True)
    args = ap.parse_args(argv)
    bench = Benchmark()
    cell = bench.cell(args.workload)
    traffic = Traffic(bench.config(cell), bench.mix(cell), args.seed)
    checks = run_control(traffic, args.calls, args.variant)
    for line in judge.lines(checks):
        print(line, file=sys.stderr)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "variant": args.variant, "calls": args.calls,
                      "correct": judge.passed(checks),
                      "limits": judge.with_limits(checks)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
