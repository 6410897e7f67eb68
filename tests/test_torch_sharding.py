"""PyTorch port: the mesh, collectives, sharded MSM and checkpoints
(parallel/{mesh,comm,msm,checkpoint}.py) on the CPU.

``msm_sharded`` runs SPMD: one process per rank.  One module fixture
starts three groups at once -- 4 and 2 gloo ranks, and 1 rank with no
process group -- each rank a ``tests/torch_gloo_worker.py`` process on one
CPU thread that runs every configuration over its block of the same 16
points, then one configuration on each sub-mesh of ranks 0..d-1.  While they run, this process computes the JAX package's
``msm_sharded`` on a 4-device mesh of its virtual CPU devices (as
tests/test_sharding.py runs it).  That takes 30-50 s of XLA compile for
each configuration on a CPU, so the JAX package is held against the port
on one scan configuration; the port's every configuration and rank count
is held against the oracle, and the JAX package's own tests hold its
configurations equal to its single-device msm and the oracle.  The
window-sharded combine of one rank (``_sharded_combine``, K8 with a tail)
is held against the JAX package's steps of its ``_sharded_combine`` run
eagerly, without the 100 s compile of its shard_map.  Every comparison is
exact: canonical bytes."""

import importlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from zerocaf_tpu import EdwardsPoint as JPoint
from zerocaf_tpu import Scalar as JScalar
from zerocaf_tpu import oracle as o
from zerocaf_tpu.config import MeshConfig as JMeshConfig
from zerocaf_tpu.parallel import batch_sharding as jbatch_sharding
from zerocaf_tpu.parallel import checkpoint as jckpt
from zerocaf_tpu.parallel import make_mesh as jmake_mesh
from zerocaf_tpu.parallel import msm_sharded as jmsm_sharded
from zerocaf_tpu.models import edwards as jed
from zerocaf_tpu_torch import EdwardsPoint, Scalar
from zerocaf_tpu_torch.config import MeshConfig
from zerocaf_tpu_torch.models import ristretto as tri
from zerocaf_tpu_torch.parallel import (Communicator, batch_sharding,
                                        checkpoint, initialize_distributed,
                                        make_mesh, msm, msm_sharded, replicated)
from zerocaf_tpu_torch.parallel.mesh import Mesh

jmsm = importlib.import_module("zerocaf_tpu.parallel.msm")
tmsm = importlib.import_module("zerocaf_tpu_torch.parallel.msm")

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "torch_gloo_worker.py"
N = 16
WORLDS = (4, 2, 1)
# name -> msm_sharded keywords; shard_combine at c = 6 shares 42 windows
# over 4 ranks (padded to 44) and 2 ranks.  Every shard_combine
# configuration runs each rank's share of the combine through K8
# (combine_tables, its plain version here) with c * ndev doublings a window
# and c * rank after it.
CONFIGS = {
    "scan_c8": dict(c=8),
    "unsigned_c4": dict(c=4, signed=False),
    "shard_combine_c6": dict(c=6, shard_combine=True),
    "dense_c4": dict(c=4, dense=True),
    "dense_shard_combine_c4": dict(c=4, dense=True, shard_combine=True),
    "unsigned_shard_combine_c4": dict(c=4, signed=False, shard_combine=True),
}
JAX_CONFIG = "unsigned_c4"
# (world, d): the sub-meshes of ranks 0..d-1 that the workers build
SUBMESHES = [(4, 1), (4, 2), (2, 1)]
SUBMESH_CONFIG = "dense_c4"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _wire(point) -> bytes:
    return tri._compress(point._tuple()).numpy().tobytes()


@pytest.fixture(scope="module")
def inputs():
    """N points k_i * B and scalars s_i from a seed, with the oracle's
    aggregate."""
    rng = np.random.default_rng(83)
    ks = [int.from_bytes(rng.bytes(32), "little") % o.R for _ in range(N)]
    ss = [int.from_bytes(rng.bytes(32), "little") % o.R for _ in range(N)]
    ss[:2] = [0, o.R - 1]
    pts = [o.scalar_mul(o.BASEPOINT, k) for k in ks]
    coords = np.stack([[o.int_to_limbs(c % o.P) for c in p] for p in pts]).astype(np.int32)
    scalars = np.stack([o.int_to_limbs(s) for s in ss]).astype(np.int32)
    total = sum(k * s for k, s in zip(ks, ss)) % o.R
    return dict(coords=coords, scalars=scalars, ks=ks, ss=ss,
                want=o.ristretto_compress(o.scalar_mul(o.BASEPOINT, total)))


def _jax_sharded(inputs, kw):
    """The JAX package's msm_sharded on 4 virtual CPU devices."""
    mesh = jmake_mesh(JMeshConfig(n_devices=4))
    sh = jbatch_sharding(mesh)
    pts = JPoint(*(jax.device_put(jnp.asarray(inputs["coords"][:, j]), sh)
                   for j in range(4)))
    sc = JScalar(jax.device_put(jnp.asarray(inputs["scalars"]), sh))
    return _jwire(jmsm_sharded(pts, sc, mesh, **kw))


def _jwire(jpoint) -> bytes:
    """Ristretto encoding of a JAX package point, through the oracle."""
    return o.ristretto_compress(tuple(int(v) % o.P for v in jpoint.to_ints()))


@pytest.fixture(scope="module")
def sharded(inputs, tmp_path_factory):
    """Every rank's results for every group size, and the JAX package's
    result for JAX_CONFIG (computed while the ranks run)."""
    tmp = tmp_path_factory.mktemp("gloo")
    spec = tmp / "spec.json"
    spec.write_text(json.dumps({"points": inputs["coords"].tolist(),
                                "scalars": inputs["scalars"].tolist(),
                                "configs": CONFIGS,
                                "submesh_config": SUBMESH_CONFIG}))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = {}
    for world in WORLDS:
        port = _free_port()
        for rank in range(world):
            out = tmp / f"w{world}_r{rank}.json"
            procs[world, rank] = (out, subprocess.Popen(
                [sys.executable, str(WORKER), str(rank), str(world), str(port),
                 str(spec), str(out)], cwd=REPO, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        jax_wire = _jax_sharded(inputs, CONFIGS[JAX_CONFIG])
        logs = {key: p.communicate(timeout=300)[0] for key, (_, p) in procs.items()}
    finally:
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = {k: logs[k] for k, (_, p) in procs.items() if p.returncode != 0}
    assert not failed, failed
    results = {key: json.loads(out.read_text()) for key, (out, _) in procs.items()}
    return dict(results=results, jax=jax_wire)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_msm_sharded_equals_oracle(inputs, sharded, world, name):
    """Every rank of every group gets the oracle's aggregate."""
    for rank in range(world):
        got = bytes.fromhex(sharded["results"][world, rank]["msm"][name])
        assert got == inputs["want"], (world, rank, name)


def test_msm_sharded_equals_jax_package(inputs, sharded):
    assert sharded["jax"] == inputs["want"]
    for rank in range(4):
        assert bytes.fromhex(sharded["results"][4, rank]["msm"][JAX_CONFIG]) == sharded["jax"]


@pytest.mark.parametrize("world", (4, 2))
def test_unequal_blocks_raise_on_every_rank(sharded, world):
    for rank in range(world):
        assert "differ in size" in sharded["results"][world, rank]["raised"]["ragged"]


@pytest.mark.parametrize("world", WORLDS)
def test_collectives(sharded, world):
    x = [[10 * r + i for i in range(3)] for r in range(world)]
    for rank in range(world):
        got = sharded["results"][world, rank]
        assert got["psum"] == [sum(col) for col in zip(*x)]
        assert got["all_gather"] == x
        assert got["all_gather_tiled"] == sum(x, [])
        assert got["ppermute"] == x[(rank - 1) % world]


@pytest.mark.parametrize("world,d", SUBMESHES)
def test_sub_mesh(inputs, sharded, world, d):
    """make_mesh(MeshConfig(n_devices=d)) in a gloo world: ranks 0..d-1 get
    a mesh of size d (a group of its own for d > 1, none for d = 1), whose
    msm_sharded over d blocks equals the oracle and whose ring ppermute
    reaches the right peers; ranks d and up get None."""
    for rank in range(world):
        got = sharded["results"][world, rank]["submesh"][str(d)]
        if rank >= d:
            assert got is None
            continue
        assert (got["size"], got["rank"], got["grouped"]) == (d, rank, d > 1)
        assert bytes.fromhex(got["msm"]) == inputs["want"]
        assert got["ppermute"] == [10 * ((rank - 1) % d) + i for i in range(3)]


def test_jax_make_mesh_takes_the_first_devices():
    """The JAX package's sub-mesh, which the port's mirrors (no compile)."""
    mesh = jmake_mesh(JMeshConfig(n_devices=2))
    assert mesh.devices.shape == (2,)
    assert list(mesh.devices) == jax.devices()[:2]


def _port_inputs(inputs):
    pts = EdwardsPoint(*(torch.tensor(inputs["coords"][:, j]) for j in range(4)))
    return pts, Scalar(torch.tensor(inputs["scalars"]))


def test_one_rank_mesh_and_its_errors(inputs, monkeypatch):
    """Without a process group the mesh has one rank and the collectives
    are local; msm_sharded(dense=True, signed=False) raises."""
    mesh = make_mesh(devices="cpu")
    assert (mesh.group, mesh.size, mesh.rank, mesh.axis) == (None, 1, 0, "data")
    assert mesh.device == torch.device("cpu")
    pts, sc = _port_inputs(inputs)
    with pytest.raises(ValueError, match="signed"):
        msm_sharded(pts, sc, mesh, c=4, dense=True, signed=False)
    with pytest.raises(ValueError, match="n_devices"):
        make_mesh(MeshConfig(n_devices=2), devices="cpu")
    with pytest.raises(ValueError, match="axis"):
        Communicator(mesh, axis="model")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices='cpu'"):
        make_mesh()
    initialize_distributed("localhost:1", 1, 0, backend="gloo")     # a no-op
    assert not torch.distributed.is_initialized()


def test_batch_sharding_gives_each_rank_its_block():
    x = torch.arange(12).view(6, 2)
    blocks = []
    for rank in range(3):
        mesh = Mesh(None, 3, rank, "data", torch.device("cpu"))
        blocks.append(batch_sharding(mesh)(x))
        assert torch.equal(replicated(mesh)(x), x)
    assert torch.equal(torch.cat(blocks), x)
    with pytest.raises(ValueError, match="divide"):
        batch_sharding(mesh)(x[:5])


class _GatheredComm:
    """Rank ``rank`` of ``ndev`` whose all_gather of bucket tables returns
    every rank's tables, given up front."""

    def __init__(self, tables, rank):
        self.tables, self.rank = tables, rank

    def axis_index(self):
        return self.rank

    def all_gather_points(self, mine):
        return self.tables


@pytest.mark.parametrize("rank", [0, 3])
def test_sharded_combine_matches_jax_steps_and_oracle(rank):
    """One rank's share of the window-sharded combine, through K8's plain
    version (c * ndev doublings a window, c * rank after them): equal to
    the JAX package's _sharded_combine steps for that rank (the per-window
    sum over ranks, _bucket_totals, _horner with stride ndev, c * rank
    doublings) and to the oracle; 7 windows over 4 ranks pad to 8."""
    rng = np.random.default_rng(85)
    ndev, c, nwin = 4, 2, 7
    nb = (1 << (c - 1)) + 1
    k = -(-nwin // ndev)
    ks = [[int.from_bytes(rng.bytes(32), "little") % o.R for _ in range(nwin * nb)]
          for _ in range(ndev)]
    ident = [0, 1, 1, 0]
    # every rank's tables, padded to k * ndev windows with identities
    g = np.zeros((4, ndev, k * ndev, nb, 22), np.int32)
    for d in range(ndev):
        for i, kk in enumerate(ks[d]):
            p = o.scalar_mul(o.BASEPOINT, kk)
            for j in range(4):
                g[j, d, i // nb, i % nb] = o.int_to_limbs(p[j] % o.P)
    g[1:3, :, nwin:, :, 0] = 1
    assert ident == [int(g[j, 0, -1, 0, 0]) for j in range(4)]
    got = tmsm._sharded_combine(tuple(torch.tensor(g[j, rank, :nwin]) for j in range(4)),
                                c, nb, _GatheredComm(tuple(torch.tensor(x) for x in g),
                                                     rank), ndev)
    loc = jmsm._tree_reduce(tuple(jnp.asarray(x[:, rank::ndev]) for x in g))
    want = jmsm._horner(jmsm._bucket_totals(loc, nb), c, stride=ndev)
    for _ in range(c * rank):
        want = jed._double(want)
    got_wire = tri._compress(got).numpy().tobytes()
    assert got_wire == tri._compress(tuple(torch.tensor(np.asarray(x))
                                           for x in want)).numpy().tobytes()
    total = sum((1 << (c * w)) * b * ks[d][w * nb + b] for d in range(ndev)
                for w in range(rank, nwin, ndev) for b in range(1, nb)) % o.R
    assert got_wire == o.ristretto_compress(o.scalar_mul(o.BASEPOINT, total))


# --- checkpoints ---------------------------------------------------------------


def test_checkpoint_files_cross_between_packages(tmp_path):
    """A file written by the JAX package loads in the port, and the
    reverse; both write the same bytes for the same checkpoint."""
    rng = np.random.default_rng(84)
    k = int.from_bytes(rng.bytes(32), "little") % o.R
    p = o.scalar_mul(o.BASEPOINT, k)
    limbs = np.stack([o.int_to_limbs(c % o.P) for c in p]).astype(np.int32)
    jp = JPoint(*(jnp.asarray(limbs[j]) for j in range(4)))
    tp = EdwardsPoint(*(torch.tensor(limbs[j]) for j in range(4)))
    want = o.ristretto_compress(p)

    jckpt.save(str(tmp_path / "j.ckpt"), jp, 3, {"n": 64})
    got, nb, meta = checkpoint.load(str(tmp_path / "j.ckpt"))
    assert (nb, meta) == (3, {"n": 64}) and _wire(got) == want

    checkpoint.save(str(tmp_path / "t.ckpt"), tp, 5, {"block_size": 8})
    back, nb, meta = jckpt.load(str(tmp_path / "t.ckpt"))
    assert (nb, meta) == (5, {"block_size": 8})
    assert _jwire(back) == want
    checkpoint.save(str(tmp_path / "t3.ckpt"), tp, 3, {"n": 64})
    assert (tmp_path / "t3.ckpt").read_bytes() == (tmp_path / "j.ckpt").read_bytes()
    assert checkpoint.load(str(tmp_path / "none.ckpt")) is None


def test_msm_with_checkpoints_resumes(inputs, tmp_path):
    """Blocks of 4: the one-shot sum; then a job stopped after block 2
    (its file says next_block 2) resumed over all blocks."""
    pts, sc = _port_inputs(inputs)
    path = str(tmp_path / "msm.ckpt")
    full = checkpoint.msm_with_checkpoints(pts, sc, block_size=4, path=path, c=4)
    assert _wire(full) == inputs["want"]
    assert checkpoint.load(path)[1] == 4
    part = str(tmp_path / "part.ckpt")
    checkpoint.msm_with_checkpoints(pts[:8], sc[:8], block_size=4, path=part, c=4)
    assert checkpoint.load(part)[1] == 2
    resumed = checkpoint.msm_with_checkpoints(pts, sc, block_size=4, path=part, c=4)
    assert _wire(resumed) == _wire(msm(pts, sc, c=4)) == inputs["want"]
    assert checkpoint.load(part)[1] == 4
