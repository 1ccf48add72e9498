"""Nothing a cell runs loads JAX or the JAX package, and the reference
loads nothing of the program either. Each import path runs in a fresh
subprocess; top-level module names are compared whole (the port's name
begins with the JAX package's)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
JAX = {"jax", "jaxlib", "flax", "nextplaid_tpu"}

PRELUDE = f"""
import json, sys
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]
"""
REPORT = "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"


def _modules(code: str) -> set:
    proc = subprocess.run([sys.executable, "-c", PRELUDE + code + "\n" + REPORT],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_a_cells_import_path_loads_no_jax(cell):
    loaded = _modules(f"""
from plaidbench import harness, deploy, judge, profiling
from plaidbench.registry import Registry
reg = Registry()
mix = reg.mix(reg.cell({cell!r})["traffic"])
reg.driver(mix["driver"])
for m in reg.per_layer({cell!r}):
    reg.reader(m["name"])
import nextplaid_tpu_torch.index, nextplaid_tpu_torch.index.search
""")
    assert "nextplaid_tpu_torch" in loaded
    assert not loaded & JAX


def test_the_reference_loads_nothing_of_the_program():
    loaded = _modules("from reference import plaid")
    assert "torch" in loaded
    assert not loaded & (JAX | {"nextplaid_tpu_torch", "plaidbench"})
    for f in (BENCH / "reference").glob("*.py"):
        for line in f.read_text().splitlines():
            if line.lstrip().startswith(("import ", "from ")):
                assert "nextplaid" not in line and "jax" not in line, (f, line)
