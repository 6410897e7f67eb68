"""One run of one cell: set-up, warm-up, the measured window, the traced
stretch, the comparison with the reference, and the result line.

A cell of one rank runs in this process.  A cell of several ranks (the pod
configuration) runs one process a rank: this process is rank 0 and starts
the others (``portbench.pod_rank``), which meet it at a free localhost port.
Every rank builds the same traffic from the seed and holds its block of the
batch.  Before each call rank 0 tells the others, through a host-side
all_reduce of a gloo group, whether to go on; the call is timed on rank 0
from there to its result's host bytes.  Once the window has closed every
rank reports the forbidden modules (JAX's, the JAX package) that its
process holds, and rank 0 hands them on with the result.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import math
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from . import faults, judge
from .spec import ROOT, Benchmark
from .trace import profile_calls
from .traffic import Traffic

WARMUP_CALLS = 2
STRETCH_S = 1.5            # the traced stretch's target length
STRETCH_CALLS = (3, 32)    # its fewest and most calls
RANK_TIMEOUT_S = 300
FORBIDDEN = ("jax", "jaxlib", "flax", "zerocaf_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``zerocaf_tpu_torch`` is not ``zerocaf_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Options:
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"          # "cpu" only in the benchmark's own tests
    fault: str | None = None      # tests only (faults.FAULTS)
    overrides: dict | None = None  # tests only: {"config": {...}, "mix": {...}}
    warmup: int = WARMUP_CALLS


@dataclasses.dataclass
class Readings:
    """What the metric readers read."""

    bench: Benchmark
    traffic: Traffic
    lanes_per_call: int
    calls: list                   # the window's (start, dispatched, end)
    setup_s: float
    window_peak_bytes: int        # the largest rank's
    trace: object                 # trace.Trace of rank 0, or None
    traced_batches: list
    window_bits: int | None
    port_kernels: list
    block: slice                  # rank 0's rows of the batch
    world: int


def _overridden(base: dict, extra: dict | None) -> dict:
    return {**base, **(extra or {})}


class Session:
    """One rank's run of a cell."""

    def __init__(self, bench, cell, opts: Options, rank: int = 0, world: int = 1,
                 control=None):
        from . import drivers

        over = opts.overrides or {}
        self.bench, self.cell, self.opts = bench, cell, opts
        self.rank, self.world, self.control = rank, world, control
        self.config = _overridden(bench.config(cell), over.get("config"))
        self.mix = _overridden(bench.mix(cell), over.get("mix"))
        if opts.device == "cuda":
            self.device = torch.device("cuda", rank)
            torch.cuda.set_device(self.device)
        else:
            self.device = torch.device("cpu")
        self.log = [("imports", time.perf_counter())]
        self.traffic = Traffic(self.config, self.mix, opts.seed)
        self.log.append(("traffic", time.perf_counter()))
        self.driver = drivers.open_driver(self.traffic, self.config.get("route", {}),
                                          self.device, rank, world)
        self.log.append(("entry", time.perf_counter()))
        faults.install(opts.fault, self.driver, self.traffic, rank)
        self.port_kernels = drivers.port_kernel_names()
        self.n_calls = 0
        self.records: list = []
        self.batches_run: list = []

    # -- calls ---------------------------------------------------------------

    def call(self):
        """One call on the next batch in turn: (start, dispatched, end)."""
        b = self.n_calls % len(self.traffic.batches)
        t0 = time.perf_counter()
        out = self.driver.dispatch(b)
        t1 = time.perf_counter()
        host = self.driver.fetch(out)
        t2 = time.perf_counter()
        if host is not None:
            self.records.append(judge.capture(self.traffic, self.n_calls, b, host))
        self.batches_run.append(b)
        self.n_calls += 1
        return t0, t1, t2

    def _agree(self, value: int, op: str) -> int:
        """All ranks' value reduced by op ("min" or "max") on the host:
        rank 0's decisions reach the others."""
        if self.control is None:
            return value
        t = torch.tensor([value], dtype=torch.int64)
        dist.all_reduce(t, op=getattr(dist.ReduceOp, op.upper()), group=self.control)
        return int(t.item())

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0

    # -- the run -------------------------------------------------------------

    def run(self, process_start: float) -> dict | None:
        for _ in range(self.opts.warmup):
            self._agree(1, "min")
            self.call()
        self._sync()
        self.log.append(("warm-up", time.perf_counter()))
        setup_peak = self._peak()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.records.clear()
        first = self.n_calls
        calls = []
        deadline = None
        while True:
            go = 1 if self.rank else int(deadline is None
                                         or calls[-1][2] < deadline)
            if not self._agree(go, "min"):
                break
            calls.append(self.call())
            if deadline is None:
                deadline = calls[0][0] + self.opts.seconds
        self._sync()
        window_peak = self._peak()
        n_window = self.n_calls - first
        trace = None
        if self.opts.trace:
            med = float(np.median([e - s for s, _, e in calls])) if calls else 1.0
            want = min(STRETCH_CALLS[1],
                       max(STRETCH_CALLS[0], math.ceil(STRETCH_S / max(med, 1e-6))))
            n = self._agree(want if self.rank == 0 else 0, "max")
            start = self.n_calls
            trace = profile_calls(self.call, n)
            traced = self.batches_run[start:]
        stats = {"peak": max(setup_peak, self._peak()), "window_peak": window_peak,
                 "busy_s": trace.busy_s if trace else None,
                 "window_s": trace.window_s if trace else None,
                 "forbidden": forbidden_modules()}
        every = [stats]
        if self.control is not None:
            every = [None] * self.world
            dist.all_gather_object(every, stats, group=self.control)
        if self.rank:
            return None
        setup_s = calls[0][0] - process_start
        marks = [("start", process_start)] + self.log
        print("portbench: set-up " + ", ".join(
            f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:])),
            file=sys.stderr)
        readings = Readings(
            bench=self.bench, traffic=self.traffic,
            lanes_per_call=self.traffic.batch, calls=calls,
            setup_s=setup_s,
            window_peak_bytes=max(s["window_peak"] for s in every),
            trace=trace, traced_batches=traced if trace else [],
            window_bits=self.driver.window_bits(),
            port_kernels=self.port_kernels,
            block=getattr(self.driver, "rows", slice(0, self.traffic.batch)),
            world=self.world)
        return self._result(readings, every, n_window)

    def _result(self, r: Readings, every: list, n_window: int) -> dict:
        checks, failed = judge.judge(self.traffic, self.records)
        kind = "per_layer" if self.opts.trace else "end_to_end"
        metrics = {}
        for m in self.bench.metrics(self.cell, kind):
            value = self.bench.reader(m["name"])(r)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        cuda = self.device.type == "cuda"
        device = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(self.device) if cuda else "cpu",
                  "count": self.world,
                  "memory_peak_bytes": max(s["peak"] for s in every)}
        out = {"correct": judge.passed(checks), "attempted": len(self.records),
               "failed": failed, "metrics": metrics, "device": device}
        if r.trace is not None:
            device["busy_s"] = float(np.mean([s["busy_s"] for s in every]))
            device["window_s"] = float(np.mean([s["window_s"] for s in every]))
            out["breakdown"] = {"device_ops": r.trace.device_ops(),
                                "idle_gaps": r.trace.idle_gaps()}
            out["traced_lanes_per_s"] = (r.trace.calls * r.lanes_per_call
                                         / r.trace.window_s)
        out["window_calls"] = n_window
        out["limits"] = judge.with_limits(checks)
        out["_check_lines"] = judge.lines(checks)
        out["_forbidden"] = {rank: s["forbidden"] for rank, s in enumerate(every)
                             if s["forbidden"]}
        return out


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _join(rank: int, world: int, port: int, device: str):
    """Join the ranks' process group; returns the host-side gloo group."""
    backend = "nccl" if device == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    return dist.new_group(backend="gloo",
                          timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))


def run_cell(bench: Benchmark, name: str, opts: Options,
             process_start: float) -> dict:
    """Run cell ``name`` once; returns the result line's object (plus
    ``_check_lines``, and ``_forbidden``: rank -> the forbidden modules its
    process held once the window had closed).  process_start: the process's start on the
    ``time.perf_counter`` clock."""
    cell = bench.cell(name)
    world = int(_overridden(bench.config(cell),
                            (opts.overrides or {}).get("config")).get("ranks", 1))
    if world == 1:
        return Session(bench, cell, opts).run(process_start)
    if opts.device == "cuda":
        from .drivers import build_kernels
        build_kernels()               # once, before the ranks load them
    port = _free_port()
    job = {"workload": name, "seed": opts.seed, "seconds": opts.seconds,
           "trace": opts.trace, "device": opts.device, "fault": opts.fault,
           "overrides": opts.overrides, "warmup": opts.warmup, "port": port,
           "world": world, "root": str(bench.root), "base": str(bench.base)}
    procs = [subprocess.Popen([sys.executable, "-m", "portbench.pod_rank",
                               json.dumps({**job, "rank": r})],
                              cwd=ROOT, stdout=sys.stderr)
             for r in range(1, world)]
    try:
        control = _join(0, world, port, opts.device)
        result = Session(bench, cell, opts, 0, world, control).run(process_start)
        dist.destroy_process_group()
    except BaseException:
        for p in procs:               # they would wait on rank 0 until timeout
            p.kill()
        raise
    finally:
        for p in procs:
            try:
                p.wait(timeout=RANK_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise RuntimeError(f"ranks 1..{world - 1} exited with {codes}")
    return result


def rank_main(job: dict) -> None:
    """A rank above 0 of a several-rank cell (``portbench.pod_rank``)."""
    bench = Benchmark(job["root"], job["base"])
    opts = Options(job["seed"], job["seconds"], job["trace"], job["device"],
                   job["fault"], job["overrides"], job["warmup"])
    control = _join(job["rank"], job["world"], job["port"], job["device"])
    Session(bench, bench.cell(job["workload"]), opts, job["rank"], job["world"],
            control).run(0.0)
    dist.destroy_process_group()
