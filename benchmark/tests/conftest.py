"""Helpers of the benchmark's own tests (`python -m pytest benchmark/tests`).

`tiny_checkout` copies BENCHMARK.json and this folder into a temporary
root with every configuration and mix cut to a size the CPU runs in
seconds; the program itself is imported from this checkout.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from nextplaid_tpu_torch.ops.kmeans import num_partitions_heuristic  # noqa: E402
from plaidbench import corpus  # noqa: E402


def tiny_checkout(dest: Path, docs: int = 300, batch: int = 16, staged_route_above: int = 1000) -> Path:
    """A copy of the benchmark at `dest`, cut to `docs` documents, batches
    of `batch` and a two-batch pool; the staged mix routes staged above
    `staged_route_above` embeddings (the deployment's is 16M). Each
    configuration keeps its deployment's four k-means cells a topic: its
    topics are cut with its corpus to a quarter of the K the build takes."""
    dest = Path(dest)
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(BENCH, dest / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for f in (dest / "benchmark" / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg["documents"] = docs
        tokens = int(corpus.doclens(cfg, 0).sum())
        cfg["topics"] = max(1, num_partitions_heuristic(tokens) // 4)
        f.write_text(json.dumps(cfg))
    for f in (dest / "benchmark" / "traffic").glob("*.json"):
        mix = json.loads(f.read_text())
        mix.update(batch=batch, pool_batches=2, trace_seconds=0.5)
        mix["check"] = {"queries": 8, "batches": 1}
        if mix.get("reference") == "staged":
            mix["search"]["exact_max_embeddings"] = staged_route_above
        f.write_text(json.dumps(mix))
    return dest


@pytest.fixture
def tiny(tmp_path):
    return tiny_checkout(tmp_path)
