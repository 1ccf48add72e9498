"""Finds every piece of a cell by name, so that a later change adds a
configuration, a traffic mix, a driver kind or a per-layer metric by adding
files and entries, never by editing one:

- BENCHMARK.json at the checkout's root: cells, configurations, metrics;
- a configuration's sizes in the file its `configs` entry names;
- a traffic mix in `benchmark/traffic/<mix>.json`, whose `driver` names
  `benchmark/drivers/<kind>.py` (a module with `drive(run)`);
- a per-layer metric's reader in `benchmark/metrics/<metric>.py` (a module
  with `read(ctx)` that returns a number, or None when it finds nothing).
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, prefix: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no {prefix} at {path}")
    name = prefix + re.sub(r"[^A-Za-z0-9_]", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Registry:
    """BENCHMARK.json and the files it leads to, under `root`."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench_dir = self.root / "benchmark"
        self.spec = _json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return _json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def mix(self, name: str) -> dict:
        return _json(self.bench_dir / "traffic" / f"{name}.json")

    def driver(self, kind: str) -> ModuleType:
        return _module(self.bench_dir / "drivers" / f"{kind}.py", "plaidbench_driver_")

    def reader(self, metric: str) -> ModuleType:
        return _module(self.bench_dir / "metrics" / f"{metric}.py", "plaidbench_metric_")

    def end_to_end(self, cell: str) -> List[dict]:
        """The end-to-end metrics the cell reports."""
        return [
            m for m in self.spec["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]
        ]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics read in the cell's traced run: those that
        list it, and those without a list whose end-to-end metric it reports."""
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [
            m for m in self.spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)
        ]
