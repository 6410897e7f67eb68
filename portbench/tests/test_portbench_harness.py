"""The harness on the CPU: the description resolves by name, nothing imports
JAX, the trace arithmetic, every mix judged right at a tiny size and wrong
under each fault, the controls, and the command's refusal without a card.

The runs drive the program's plain versions through ``harness.run_cell``
with ``device="cpu"``, which skips only the command's look for a card.  An
MSM call at a tiny batch takes seconds on the CPU (the dense route's lane
reduction), so those runs use the width c = 3 and one call.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, judge, run
from portbench.control import run_control
from portbench.spec import NAME, ROOT, UNIT, Benchmark
from portbench.trace import Trace, name_matcher
from portbench.traffic import Traffic

BASE = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "zerocaf_tpu"}

SMALL = {
    "verifier_msm_2p20.wire": {"config": {"batch": 8, "pool": 8, "route": {"c": 3}},
                               "mix": {"batches": 2}},
    "kex_2p19.dh": {"config": {"batch": 64, "pool": 8},
                    "mix": {"batches": 2, "invalid_every": 16, "check_lanes": 64}},
    "verifier_msm_2p20.resident": {"config": {"batch": 8, "pool": 8, "route": {"c": 3}},
                                   "mix": {"batches": 2}},
    "pod_msm_2p20_x4.resident": {"config": {"batch": 16, "pool": 8, "ranks": 2,
                                            "route": {"c": 3, "dense": True,
                                                      "shard_combine": True}},
                                 "mix": {"batches": 2}},
}
POD = "pod_msm_2p20_x4.resident"


def _bench(cell: str, tmp_path: Path) -> Benchmark:
    """The benchmark; for the four-card cell, which ``BENCHMARK.json`` does
    not hold yet (its configuration file does), a copy of the description
    with the cell and its metrics added, beside the benchmark's files."""
    if cell != POD:
        return Benchmark()
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "pod_msm_2p20_x4", "source": "x", "reduced": [],
                            "file": "portbench/configs/pod_msm_2p20_x4.json",
                            "why": "x"})
    spec["workloads"].append({"name": POD, "config": "pod_msm_2p20_x4",
                              "traffic": "resident", "chips": 4, "why": "x"})
    for m in spec["end_to_end"]:
        if m["name"].endswith(".host_paced"):
            m["workloads"].append(POD)
    spec["per_layer"].append(
        {"name": "collective_ms", "unit": "ms", "better": "lower",
         "source": "device_trace", "layer": "collectives",
         "moves": "lanes_per_s.host_paced", "workloads": [POD]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp_path / "portbench").symlink_to(BASE)
    return Benchmark(tmp_path, BASE)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax():
    files = sorted(BASE.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not _imports(f) & FORBIDDEN, f


def test_reference_imports_nothing_of_the_program():
    for f in sorted((BASE / "reference").rglob("*.py")):
        assert _imports(f) <= {"__future__", "numpy"}, f
    code = ("import sys, portbench.reference.curve, portbench.traffic, "
            "portbench.judge, portbench.control; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & (FORBIDDEN | {"zerocaf_tpu_torch", "torch"})


def test_every_cell_resolves_by_name():
    bench = Benchmark()
    spec = bench.spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    names += [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]]
    assert len(names) == len(set(names))
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"]), m
        bench.reader(m["name"])
        if m["name"].endswith("_roofline"):
            assert hasattr(bench.roofline(m["name"][: -len("_roofline")]), "least_seconds")
    for cell in spec["workloads"]:
        assert NAME.fullmatch(cell["name"]) and NAME.fullmatch(cell["traffic"])
        config, mix = bench.config(cell), bench.mix(cell)
        assert config["name"] == cell["config"] and mix["name"] == cell["traffic"]
        assert int(config.get("ranks", 1)) == cell["chips"]
        e2e = {m["name"] for m in bench.metrics(cell, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = bench.metrics(cell, "per_layer")
        assert per_layer and all(m["moves"] in e2e for m in per_layer)
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json_of(c["file"])["reduced"] == c["reduced"]


def json_of(rel: str) -> dict:
    return json.loads((ROOT / rel).read_text())


def test_new_files_are_found_without_an_edit(tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(BASE, base, ignore=shutil.ignore_patterns("__pycache__", "_out"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (base / "configs" / "kex_2p15.json").write_text(json.dumps(
        {"name": "kex_2p15", "batch": 32768, "ranks": 1, "pool": 64, "reduced": []}))
    (base / "mixes" / "keygen.json").write_text(json.dumps(
        {"name": "keygen", "op": "keygen", "path": "wire", "batches": 2}))
    (base / "metrics" / "calls_in_window.py").write_text(
        "def read(r):\n    return len(r.calls)\n")
    (base / "roofline" / "k_comb.py").write_text(
        "def least_seconds(r):\n    return (1e-3, 2e-3)\n")
    spec["configs"].append({"name": "kex_2p15", "source": "x",
                            "file": "portbench/configs/kex_2p15.json", "reduced": [],
                            "why": "x"})
    spec["workloads"].append({"name": "kex_2p15.keygen", "config": "kex_2p15",
                              "traffic": "keygen", "chips": 1, "why": "x"})
    for m in spec["end_to_end"]:
        if m["name"] == "lanes_per_s":
            m["workloads"].append("kex_2p15.keygen")
    spec["per_layer"] += [
        {"name": "calls_in_window", "unit": "calls", "better": "higher",
         "source": "host_clock", "layer": "serving", "moves": "lanes_per_s"},
        {"name": "k_comb_roofline", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "kernels", "moves": "lanes_per_s",
         "workloads": ["kex_2p15.keygen"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Benchmark(tmp_path, base)
    cell = bench.cell("kex_2p15.keygen")
    assert bench.config(cell)["batch"] == 32768 and bench.mix(cell)["op"] == "keygen"
    names = {m["name"] for m in bench.metrics(cell, "per_layer")}
    assert {"calls_in_window", "k_comb_roofline", "dispatch_ms"} <= names
    readings = _readings(bench, _trace([("void zc::k_comb<8>(int*)", "kernel", 0, 4_000_000)]))
    assert bench.reader("calls_in_window")(readings) == 2
    assert bench.reader("k_comb_roofline")(readings) == pytest.approx(100 * 2e-3 / 2e-3)


def _trace(device, host=(), span=(0, 10_000_000), calls=2):
    return Trace(list(device), list(host), span, calls)


def _readings(bench, trace, traffic=None):
    return harness.Readings(
        bench=bench, traffic=traffic, lanes_per_call=8,
        calls=[(0.0, 0.1, 0.2), (0.2, 0.3, 0.5)], setup_s=1.0,
        window_peak_bytes=2**30, trace=trace, traced_batches=[0],
        window_bits=None, port_kernels=["k_mul", "k_mul_chain", "k_ladder"],
        block=slice(0, 8), world=1)


def test_trace_arithmetic():
    host = [("aten::add", 20, 30), ("cudaLaunchKernel", 22, 24), ("aten::cat", 60, 100)]
    device = [("void zc::k_mul<zc32::ModP>(int const*)", "kernel", 0, 10),
              ("void at::native::CatArrayBatchedCopy<int>()", "kernel", 5, 20),
              ("Memcpy HtoD (Pageable -> Device)", "memcpy", 30, 40),
              ("_Z11k_mul_chainPji", "kernel", 50, 56),
              ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgs)", "kernel", 56, 60)]
    tr = _trace(device, host, span=(0, 100), calls=2)
    assert tr.busy_s == pytest.approx(40e-9)
    bench = Benchmark()
    r = _readings(bench, tr)
    assert bench.reader("device_idle_pct")(r) == pytest.approx(60.0)
    assert bench.reader("launches_per_call")(r) == 2.0
    assert bench.reader("glue_device_ms")(r) == pytest.approx(15e-6 / 2)
    assert bench.reader("lanes_per_s")(r) == pytest.approx(16 / 0.5)
    assert bench.reader("dispatch_ms")(r) == pytest.approx(100.0)
    assert bench.reader("peak_mem_gib")(r) == 1.0
    gaps = dict(tr.idle_gaps())
    assert gaps == pytest.approx({"aten::add": 10e-9, "(no host op)": 10e-9,
                                  "aten::cat": 40e-9})
    assert name_matcher("k_mul")("void zc::k_mul<zc32::ModP>(int const*)")
    assert not name_matcher("k_mul")("_Z11k_mul_chainPji")
    assert name_matcher("k_mul")("_Z5k_mulPKiS0_Pii")


class _Event:
    def __init__(self, name, cpu, start, end):
        self._n, self._cpu, self._s, self._d = name, cpu, start, end - start

    def name(self):
        return self._n

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CPU if self._cpu else DeviceType.CUDA

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def test_trace_reduce_leaves_out_range_mirrors():
    from types import SimpleNamespace

    from portbench.trace import reduce
    events = [_Event("portbench.stretch", True, 0, 100),
              _Event("nccl:all_gather", True, 10, 12),
              _Event("portbench.stretch", False, 0, 100),      # mirrors
              _Event("nccl:all_gather", False, 20, 40),
              _Event("ncclDevKernel_AllGather_RING_LL(x)", False, 25, 40),
              _Event("Memset (Device)", False, 50, 52)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    tr = reduce(prof, 1)
    assert tr.span == (0, 100)
    assert [d[:2] for d in tr.device] == [("ncclDevKernel_AllGather_RING_LL(x)", "kernel"),
                                          ("Memset (Device)", "memset")]
    assert tr.busy_s == pytest.approx(17e-9)


def test_roofline_arithmetic():
    bench = Benchmark()
    tr_dh = Traffic({"batch": 1024, "pool": 4}, {"op": "dh", "batches": 1}, 1)
    ladder = _trace([("zc::k_ladder(int const*)", "kernel", 0, 2_000_000)], calls=1)
    r = _readings(bench, ladder, tr_dh)
    work = 1024 * (1401 * 104 + 1008 * 76) / (989.5e12 / 16)
    assert bench.reader("k_ladder_roofline")(r) == pytest.approx(100 * work / 2e-3)
    assert bench.reader("k_bucket_accum_roofline")(r) is None
    tr_msm = Traffic({"batch": 64, "pool": 4}, {"op": "msm", "batches": 1}, 1)
    accum = _trace([("zc::k_bucket_accum(unsigned int const*)", "kernel", 0, 1_000_000)],
                   calls=1)
    r = _readings(bench, accum, tr_msm)
    r.window_bits, r.block = 6, slice(0, 64)
    mod = bench.roofline("k_bucket_accum")
    digits = mod.nonzero_digits(tr_msm.batches[0].args[1], 6)
    assert 64 * 42 * 0.9 < digits <= 64 * 42
    work = digits * 10 * 104 / (989.5e12 / 16)
    moved = (64 * (352 + 4 * 42) + 42 * 33 * 352) / 3.35e12     # the tables win here
    assert mod.least_seconds(r) == pytest.approx((work, moved))
    assert bench.reader("k_bucket_accum_roofline")(r) == pytest.approx(100 * moved / 1e-3)


def _run(cell, tmp_path, fault=None, trace=False):
    """One run at the cell's tiny size; the result with its private keys
    (``_check_lines``, ``_forbidden``) that ``run.report`` takes off."""
    opts = harness.Options(2**31 + 99, 0.01, trace, "cpu", fault, SMALL[cell], warmup=0)
    return harness.run_cell(_bench(cell, tmp_path), cell, opts, time.perf_counter())


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_mix_judged_right(cell, tmp_path, monkeypatch, capfd):
    res = _run(cell, tmp_path, trace=cell == "kex_2p19.dh")
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert res["limits"]["compared"]["value"] >= 1
    assert res["_forbidden"] == {}
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    assert run.report(res) == 0
    printed = capfd.readouterr()
    line = json.loads(printed.out.strip().splitlines()[-1])
    assert list(line)[-1] == "limits" and line["correct"]
    assert printed.err.strip().splitlines()[-1].startswith("compared: ")


def test_forbidden_module_on_another_rank_refuses_the_result(tmp_path, monkeypatch,
                                                              capfd):
    """Rank 1's process imports a module named ``flax`` (a dummy placed first
    on its path): rank 0 learns of it and the command prints no result."""
    dummy = tmp_path / "dummy"
    dummy.mkdir()
    (dummy / "flax.py").write_text("")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(dummy)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    res = _run(POD, tmp_path, "flax_on_rank1")
    assert res["_forbidden"] == {1: ["flax"]}
    assert run.report(res) == 3
    printed = capfd.readouterr()
    assert printed.out == "" and "rank 1: flax" in printed.err


@pytest.mark.parametrize("cell,fault", [
    ("verifier_msm_2p20.wire", "flip_byte"),
    ("verifier_msm_2p20.wire", "half_batch"),
    ("kex_2p19.dh", "flip_byte"),
    ("kex_2p19.dh", "half_batch"),
    ("kex_2p19.dh", "unchanged"),
    ("verifier_msm_2p20.resident", "flip_byte"),
    ("verifier_msm_2p20.resident", "half_batch"),
    (POD, "skip_exchange"),
])
def test_fault_judged_wrong(cell, fault, tmp_path):
    res = _run(cell, tmp_path, fault)
    assert not res["correct"] and res["failed"] >= 1


@pytest.mark.parametrize("cell,variant", [
    ("verifier_msm_2p20.wire", "edwards_encoding"),
    ("kex_2p19.dh", "edwards_encoding"),
    ("kex_2p19.dh", "lenient_decode"),
])
def test_control_judged_wrong(cell, variant):
    bench = Benchmark()
    c = bench.cell(cell)
    over = SMALL[cell]
    traffic = Traffic({**bench.config(c), **over["config"]}, {**bench.mix(c), **over["mix"]}, 5)
    checks = run_control(traffic, 4, variant)
    assert not judge.passed(checks)
    key = "wrong_ok" if variant == "lenient_decode" else "wrong_answers"
    assert checks[key] > 0


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "verifier_msm_2p20.wire", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True)
    assert p.returncode == 2 and p.stdout == ""
    assert "CUDA card" in p.stderr


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the wire cell on the card, judged right."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "kex_2p19.dh", "--seed", "7", "--seconds", "2",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
    assert np.isfinite(json.loads(p.stdout.strip().splitlines()[-1])
                       ["metrics"]["lanes_per_s"]["value"])
