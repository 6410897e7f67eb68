"""The benchmark's description: ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, metric or
kernel's roofline count is a file of its own, found by its name:

    configs/<config>.json     a deployment's sizes and route
    mixes/<traffic>.json      a traffic mix's parameters
    metrics/<metric>.py       a metric's reader, ``read(readings)``; a
                              ``<kernel>_roofline`` metric without a file
                              of its own is read by ``metrics/roofline.py``
                              from ``roofline/<kernel>.py``, and a metric
                              ``<base>.<group>`` by ``<base>``'s reader

so a cell, a mix, a metric or a roofline count is added with new files and
new entries in ``BENCHMARK.json``, and no file changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
ROOFLINE_SUFFIX = "_roofline"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Benchmark:
    """``BENCHMARK.json`` with its cells resolved to their files.  root is
    the directory that holds ``BENCHMARK.json``; base the benchmark's own
    directory (the one with ``configs/``, ``mixes/``, ``metrics/``)."""

    def __init__(self, root: Path = ROOT, base: Path = HERE):
        self.root, self.base = Path(root), Path(base)
        self.spec = load_json(self.root / "BENCHMARK.json")
        self.configs = {c["name"]: c for c in self.spec["configs"]}
        self.cells = {w["name"]: w for w in self.spec["workloads"]}

    def cell(self, name: str) -> dict:
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(has {sorted(self.cells)})")
        return self.cells[name]

    def config(self, cell: dict) -> dict:
        entry = self.configs[cell["config"]]
        return load_json(self.root / entry["file"])

    def mix(self, cell: dict) -> dict:
        return load_json(self.base / "mixes" / f"{cell['traffic']}.json")

    def metrics(self, cell: dict, kind: str) -> list[dict]:
        """The cell's metrics of one kind ("end_to_end" or "per_layer"):
        those that list it, and those without a list whose ``moves`` (a
        per-layer metric) the cell reports."""
        e2e = [m for m in self.spec["end_to_end"]
               if cell["name"] in m.get("workloads", [cell["name"]])]
        if kind == "end_to_end":
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (cell["name"] in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]

    def reader(self, metric: str):
        """The function that reads a metric: ``read`` of ``metrics/<name>.py``;
        a name ``<base>.<group>`` without a file of its own is read as
        ``<base>`` (one quantity reported apart for a group of cells)."""
        base = metric.split(".")[0]
        path = self.base / "metrics" / f"{metric}.py"
        if not path.exists():
            path = self.base / "metrics" / f"{base}.py"
        kernel = None
        if not path.exists() and base.endswith(ROOFLINE_SUFFIX):
            path = self.base / "metrics" / "roofline.py"
            kernel = base[: -len(ROOFLINE_SUFFIX)]
        module = load_module(path, f"portbench_metric_{metric}")
        if kernel is None:
            return module.read
        return lambda readings: module.read(readings, kernel)

    def roofline(self, kernel: str):
        """The module that counts one kernel's least time:
        ``roofline/<kernel>.py``."""
        return load_module(self.base / "roofline" / f"{kernel}.py",
                           f"portbench_roofline_{kernel}")


def load_module(path: Path, name: str):
    """Import a file of the benchmark by its path (a metric's name may hold
    dots, which an import statement cannot)."""
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
