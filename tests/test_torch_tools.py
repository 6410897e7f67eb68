"""PyTorch port: the tools ``zerocaf_tpu_torch.tools.dist_smoke`` and
``zerocaf_tpu_torch.tools.pod_msm`` on CPU gloo ranks.

The module starts its rank processes in the background, one CPU thread
each, all at once: dist_smoke on 2 ranks, and pod_msm --cpu on 2 ranks at
64 points (--log2n 6, --iters 1) on the default route and on --dense
--shard-combine.  pod_msm runs with the signed comb at width 8 and its
table cache in a temporary directory (no width-14 table on a CPU).  Its
encoding is held against the JAX package's oracle of (sum k_i s_i mod r) B
for make_inputs(64, 0, "cpu")."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from zerocaf_tpu import oracle as o
from zerocaf_tpu_torch import RistrettoPoint
from zerocaf_tpu_torch.models import edwards
from zerocaf_tpu_torch.tools import pod_msm

REPO = Path(__file__).resolve().parent.parent
LOG2N = 6
POD_RUNS = {"scan": [], "dense_shard_combine": ["--dense", "--shard-combine"]}
POD_CODE = """
import sys
from zerocaf_tpu_torch.models import edwards
edwards.COMB_WIDTH_SIGNED = 8
edwards.CACHE_DIR = sys.argv[1]
from zerocaf_tpu_torch.tools import pod_msm
pod_msm.main(sys.argv[2:])
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """The rank processes, started together: {run: [Popen a rank]}."""
    cache = str(tmp_path_factory.mktemp("comb"))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")

    def start(args):
        return subprocess.Popen([sys.executable, *args], cwd=REPO, env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)

    port = _free_port()
    runs = {"dist_smoke": [start(["-m", "zerocaf_tpu_torch.tools.dist_smoke",
                                  str(pid), "2", str(port), "--device", "cpu"])
                           for pid in range(2)]}
    for name, flags in POD_RUNS.items():
        port = _free_port()
        runs[name] = [start(["-c", POD_CODE, cache, "--cpu", "--log2n", str(LOG2N),
                             "--iters", "1", *flags, "--coordinator",
                             f"localhost:{port}", "--num-processes", "2",
                             "--process-id", str(pid)])
                      for pid in range(2)]
    yield runs
    for ranks in runs.values():
        for p in ranks:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def outputs(procs):
    """{run: [(returncode, stdout, stderr) a rank]}, once every rank ends."""
    return {name: [(p, *p.communicate(timeout=300)) for p in ranks]
            for name, ranks in procs.items()}


@pytest.fixture(scope="module")
def want(procs, tmp_path_factory):
    """The JAX package's oracle encoding of the harness's MSM at 64 points,
    and the port's inputs, checked: the points are k_i B."""
    saved = edwards.COMB_WIDTH_SIGNED, edwards.CACHE_DIR
    edwards.COMB_WIDTH_SIGNED = 8
    edwards.CACHE_DIR = str(tmp_path_factory.mktemp("comb_here"))
    try:
        k, s = pod_msm.input_scalars(1 << LOG2N, pod_msm.SEED, "cpu")
        pts, s2 = pod_msm.make_inputs(1 << LOG2N, pod_msm.SEED, "cpu")
    finally:
        edwards.COMB_WIDTH_SIGNED, edwards.CACHE_DIR = saved
    ks, ss = k.to_ints(), s.to_ints()
    assert list(s2.to_ints()) == list(ss)
    wire = RistrettoPoint(pts).compress().numpy()
    for i in range(0, 1 << LOG2N, 9):
        assert bytes(wire[i]) == o.ristretto_compress(o.scalar_mul(o.BASEPOINT, int(ks[i])))
    total = sum(int(a) * int(b) for a, b in zip(ks, ss)) % o.R
    return o.ristretto_compress(o.scalar_mul(o.BASEPOINT, total)).hex()


def test_inputs_are_seeded(procs):
    k, s = pod_msm.input_scalars(8, 0, "cpu")
    k2, s2 = pod_msm.input_scalars(8, 0, "cpu")
    k3, _ = pod_msm.input_scalars(8, 1, "cpu")
    assert list(k.to_ints()) == list(k2.to_ints()) and list(s.to_ints()) == list(s2.to_ints())
    assert set(k.to_ints()).isdisjoint(s.to_ints())
    assert set(k.to_ints()).isdisjoint(k3.to_ints())


def test_pod_msm_flags_are_the_jax_tools():
    """The JAX tool's flags with their defaults, and --backend."""
    a = pod_msm._parse([])
    assert (a.log2n, a.c, a.cpu, a.dense, a.shard_combine, a.iters,
            a.coordinator, a.num_processes, a.process_id, a.backend) == (
        20, 0, False, False, False, 3, None, 0, -1, None)
    assert pod_msm._parse(["--backend", "gloo"]).backend == "gloo"
    with pytest.raises(SystemExit):
        pod_msm._parse(["--backend", "mpi"])


def test_pod_msm_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--cpu"):
        pod_msm.main(["--log2n", "2"])


def test_dist_smoke_two_cpu_ranks(outputs):
    for pid, (p, out, err) in enumerate(outputs["dist_smoke"]):
        assert p.returncode == 0, err[-4000:]
        assert f"DIST_SMOKE_OK pid={pid} nprocs=2 n=16" in out, out


@pytest.mark.parametrize("run", list(POD_RUNS))
def test_pod_msm_two_cpu_ranks(outputs, want, run):
    """Rank 0 prints the JAX tool's lines: the shape, mesh 1 and 2 with
    their wall times, mesh 2's scaling efficiency, and the encoding, bit
    exact across the meshes and equal to the oracle; then one line a rank
    (no kernel launched on the CPU).  Rank 1 prints nothing."""
    (p0, out, err), (p1, out1, err1) = outputs[run]
    assert p0.returncode == 0, err[-4000:]
    assert p1.returncode == 0, err1[-4000:]
    assert out1 == ""
    lines = [json.loads(ln) for ln in out.splitlines()]
    c = 6 if "--dense" in POD_RUNS[run] else 8
    assert lines[0] == {"n": 1 << LOG2N, "c": c, "n_devices": 2,
                        "n_processes": 2, "platform": "cpu"}
    for nd, line in zip((1, 2), lines[1:3]):
        assert set(line) == {"mesh", "wall_s", "points_per_s"} and line["mesh"] == nd
        assert line["wall_s"] > 0
        assert line["points_per_s"] == pytest.approx((1 << LOG2N) / line["wall_s"])
    assert lines[3]["mesh"] == 2 and lines[3]["note"] == pod_msm.SHARED
    assert lines[3]["scaling_efficiency"] == pytest.approx(
        lines[1]["wall_s"] / (2 * lines[2]["wall_s"]))
    assert lines[4] == {"bit_exact_across_meshes": True, "encoding": want}
    assert lines[5:] == [{"rank": r, "launches": {}, "peak_bytes": None}
                         for r in range(2)]
