"""PyTorch port: ``Engine.keygen``'s spans.

Under ``torch.profiler`` one call emits the four ``zc.`` ranges of the
keygen path, once each and in order: the wide reduction, the comb's digit
recoding, the comb (K6's plain version here), the encode.  A call with no
profiler running gives the same bytes.  The key pairs themselves are
checked against the oracle, edge scalars included, in
``test_torch_serving.py``.  The comb width is patched to 8, so the CPU
builds no width-14 table.  Imports no JAX."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from zerocaf_tpu_torch import Engine
from zerocaf_tpu_torch.models import edwards as ted

SPANS = ("zc.keygen.reduce_wide", "zc.comb.recode", "zc.comb.mul", "zc.keygen.encode")
BATCH = 8


@pytest.fixture
def engine(monkeypatch, tmp_path):
    monkeypatch.setattr(ted, "COMB_WIDTH_SIGNED", 8)
    monkeypatch.setattr(ted, "CACHE_DIR", str(tmp_path))
    return Engine(batch=BATCH, device="cpu")


def _seeds(seed: int) -> torch.Tensor:
    return torch.from_numpy(
        np.random.default_rng(seed).integers(0, 256, (BATCH, 64), dtype=np.uint8))


def _host_ranges(prof) -> list:
    """(name, start_ns, end_ns) of every host event of a finished profile,
    read from the trace directly: building the profile's FunctionEvents
    takes seconds for a CPU keygen's ops."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def test_keygen_emits_its_spans_in_order(engine):
    seeds = _seeds(61)
    plain = engine.keygen(seeds)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = engine.keygen(seeds)
    ranges = _host_ranges(prof)
    spans = sorted((r for r in ranges if r[0].startswith("zc.")), key=lambda r: r[1])
    assert [name for name, _, _ in spans] == list(SPANS)
    for (_, _, end), (_, start, _) in zip(spans, spans[1:]):
        assert end <= start
    for name, lo, hi in spans:      # each range holds the work it names
        assert any(op.startswith("aten::") and lo <= s and e <= hi
                   for op, s, e in ranges), name
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)

