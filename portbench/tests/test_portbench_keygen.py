"""The key-generation cell on the CPU: it resolves by name (its own
configuration, the rate in the host-paced group), its mix is judged right at a tiny size and wrong under
the faults and the control, and its three new per-layer readers (``k_comb_roofline``, ``comb_recode_host_ms``,
``comb_recode_launches``) on synthetic traces.

The runs drive ``Engine.keygen``'s plain versions through
``harness.run_cell`` with ``device="cpu"``, the comb at width 8 so that the
CPU builds no width-14 table (the bytes do not depend on the width).
"""

import time

import pytest

from portbench import harness, judge
from portbench.control import run_control
from portbench.spec import Benchmark
from portbench.tests.test_portbench_harness import (  # noqa: F401 (autouse)
    _readings, _trace, one_thread)
from portbench.traffic import Traffic
from zerocaf_tpu_torch.models import edwards as ted

CELL = "kex_2p19.keygen"
SMALL = {"config": {"batch": 64, "pool": 8}, "mix": {"batches": 2, "check_lanes": 64}}
# as at the cell's size, fewer lanes compared a call than the batch holds
SAMPLED = {"config": {"batch": 64, "pool": 8}, "mix": {"batches": 2, "check_lanes": 8}}
NEW = ("k_comb_roofline", "comb_recode_host_ms", "comb_recode_launches")


@pytest.fixture
def comb8(monkeypatch, tmp_path):
    monkeypatch.setattr(ted, "COMB_WIDTH_SIGNED", 8)
    monkeypatch.setattr(ted, "CACHE_DIR", str(tmp_path))


def _run(fault=None, over=SMALL, seed=2**31 + 99):
    opts = harness.Options(seed, 0.01, False, "cpu", fault, over, warmup=0)
    return harness.run_cell(Benchmark(), CELL, opts, time.perf_counter())


def test_cell_resolves():
    bench = Benchmark()
    cell = bench.cell(CELL)
    config, mix = bench.config(cell), bench.mix(cell)
    assert cell["config"] == config["name"] == "kex_2p19_keygen"
    assert list(config["entries"]) == ["keygen"]
    assert config["batch"] == 2**19 and config["ranks"] == cell["chips"] == 1
    assert (mix["op"], mix["path"], mix["batches"], mix["check_lanes"]) == (
        "keygen", "wire", 4, 32)
    e2e = {m["name"] for m in bench.metrics(cell, "end_to_end")}
    assert e2e == {"lanes_per_s.host_paced", "setup_s"}     # its p90 spreads too far
    per_layer = {m["name"]: m for m in bench.metrics(cell, "per_layer")}
    assert set(NEW) | {"dispatch_ms.host_paced"} <= set(per_layer)
    assert not any(name.startswith("call_p90_ms") for name in per_layer)
    assert all(m["moves"] in e2e for m in per_layer.values())
    for name in NEW:
        assert per_layer[name]["workloads"] == [CELL]


def test_mix_judged_right(comb8):
    res = _run()
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert res["limits"]["compared"]["value"] == 64 * res["attempted"]
    assert res["_forbidden"] == {}


@pytest.mark.parametrize("fault,over", [("flip_byte", SMALL), ("half_batch", SMALL),
                                        ("half_batch", SAMPLED), ("unchanged", SMALL),
                                        ("unchanged", SAMPLED)])
def test_fault_judged_wrong(comb8, fault, over):
    res = _run(fault, over)
    assert not res["correct"] and res["failed"] >= 1


@pytest.mark.parametrize("seed,drawn", [(2**31 + 99, 0), (2**31 + 112, 1)])
def test_one_lane_fault_is_seen_where_sampled(comb8, seed, drawn):
    """``flip_byte`` alters lane 0 alone: at a batch larger than the lanes
    compared, a call fails exactly when the seed drew lane 0 for it (the
    first seed does not for the one call, the second does)."""
    res = _run("flip_byte", SAMPLED, seed)
    bench = Benchmark()
    c = bench.cell(CELL)
    traffic = Traffic({**bench.config(c), **SAMPLED["config"]},
                      {**bench.mix(c), **SAMPLED["mix"]}, seed)
    drew = sum(0 in traffic.sample_lanes(n) for n in range(res["attempted"]))
    assert res["attempted"] == 1 and drew == drawn
    assert res["failed"] == drew and res["correct"] == (drew == 0)


def test_control_judged_wrong():
    bench = Benchmark()
    c = bench.cell(CELL)
    traffic = Traffic({**bench.config(c), **SMALL["config"]},
                      {**bench.mix(c), **SMALL["mix"]}, 5)
    checks = run_control(traffic, 4, "edwards_encoding")
    assert not judge.passed(checks) and checks["wrong_answers"] == checks["compared"] > 0
    assert judge.passed(run_control(traffic, 4, "lenient_decode"))   # no decode here


def test_k_comb_roofline():
    bench = Benchmark()
    keygen = Traffic({"batch": 1024, "pool": 4}, {"op": "keygen", "batches": 1}, 1)
    comb = _trace([("void zc::k_comb(unsigned int const*, int const*)", "kernel", 0, 500_000),
                   ("void zc::k_combine(int const*)", "kernel", 0, 9_000_000)], calls=1)
    work = 1024 * 18 * 7 * 104 / (989.5e12 / 16)
    table = 18 * 8193 * 96
    moved = (1024 * (18 * 4 + 352) + table) / 3.35e12             # the table wins here
    assert bench.roofline("k_comb").least_seconds(_readings(bench, comb, keygen)) == \
        pytest.approx((work, moved))
    read = bench.reader("k_comb_roofline")
    assert read(_readings(bench, comb, keygen)) == pytest.approx(100 * moved / 0.5e-3)
    dh = Traffic({"batch": 1024, "pool": 4}, {"op": "dh", "batches": 1}, 1)
    assert read(_readings(bench, comb, dh)) is None                # not keygen
    assert read(_readings(bench, _trace([]), keygen)) is None      # no k_comb ran
    assert read(_readings(bench, None, keygen)) is None            # untraced


def test_comb_recode_readers():
    bench = Benchmark()
    host_ms, launches = (bench.reader(n) for n in NEW[1:])
    host = [("zc.comb.recode", 100, 400), ("cudaLaunchKernel", 120, 130),
            ("cuLaunchKernel", 300, 310), ("aten::add", 110, 200),
            ("cudaLaunchKernel", 450, 460),                        # after the span
            ("zc.comb.recode", 1_000, 1_600), ("cudaLaunchKernel", 1_590, 1_600),
            ("zc.comb.mul", 1_600, 2_000), ("cudaLaunchKernel", 1_700, 1_710)]
    r = _readings(bench, _trace([], host, span=(0, 3_000), calls=2))
    assert host_ms(r) == pytest.approx((300 + 600) / 1e6 / 2)
    assert launches(r) == 3 / 2
    quiet = _readings(bench, _trace([], [("zc.comb.recode", 0, 50)], calls=1))
    assert launches(quiet) == 0 and host_ms(quiet) == pytest.approx(50 / 1e6)
    parent = _readings(bench, _trace([], [("aten::add", 0, 50),
                                          ("cudaLaunchKernel", 10, 20)]))
    assert host_ms(parent) is None and launches(parent) is None   # no span
    assert host_ms(_readings(bench, None)) is None and launches(_readings(bench, None)) is None
