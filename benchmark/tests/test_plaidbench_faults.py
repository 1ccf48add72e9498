"""Whole runs of each cell at a tiny size on the CPU, past the harness's
look for a card: a sound run comes out `correct`, and each run with a
fault planted in the program comes out not correct: an answer altered
where it is produced (each query's best document id moved by one in
`PendingSearch.result`), the codec's bucket weights written at the
buckets' lower edges, and centroids that skipped k-means (Lloyd's
iterations return their initial centroids)."""

from __future__ import annotations

import json
import math
import time

import numpy as np
import pytest
import torch

from conftest import BENCH, tiny_checkout
from plaidbench import corpus, harness
from plaidbench.registry import Registry

SPEC = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
FAULT = '''
import nextplaid_tpu_torch.index.search as _s

_result = _s.PendingSearch.result


def _altered(self):
    out = _result(self)
    n = self._index.num_documents
    for r in out:
        if r.passage_ids:
            r.passage_ids[0] = (r.passage_ids[0] + 1) % n
    return out
'''


def _pin_budget_for(reg: Registry, cell: str, monkeypatch) -> None:
    """At the tiny size the bf16 grid fits any budget; give the int8 cell
    a pin budget between the two grids, as the deployment's 4,096 MB is."""
    from nextplaid_tpu_torch.index.container import _grid_bytes_for, _padded_doc_rows

    w = reg.cell(cell)
    if reg.mix(w["traffic"]).get("grid") != "int8":
        return
    cfg = reg.config(w["config"])
    rows = _padded_doc_rows(cfg["documents"])
    longest = int(corpus.doclens(cfg, 0).max())
    mb = math.ceil(_grid_bytes_for(rows, longest, cfg["dim"], "int8") / (1 << 20))
    assert _grid_bytes_for(rows, longest, cfg["dim"], "bf16") > mb << 20
    monkeypatch.setenv("NEXT_PLAID_PIN_BUDGET_MB", str(mb))


def _plant(fault: str, monkeypatch) -> None:
    import nextplaid_tpu_torch.index.search as search
    import nextplaid_tpu_torch.ops.codec as codec
    import nextplaid_tpu_torch.ops.kmeans as kmeans

    if fault == "answer_altered":
        scope = {}
        exec(FAULT, scope)
        monkeypatch.setattr(search.PendingSearch, "result", scope["_altered"])
    elif fault == "codec_weights_at_edges":
        train = codec.train_codec_buckets

        def at_edges(residual_sample, nbits):
            cutoffs, _ = train(residual_sample, nbits)
            flat = np.asarray(residual_sample, np.float32).ravel()
            return cutoffs, np.quantile(flat, np.arange(1 << nbits) / (1 << nbits)).astype(np.float32)

        monkeypatch.setattr(codec, "train_codec_buckets", at_edges)
    elif fault == "kmeans_skipped":
        monkeypatch.setattr(kmeans, "lloyd", lambda data, init, **kw: init.float().clone())


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["sound", "answer_altered", "codec_weights_at_edges", "kmeans_skipped"])
def test_a_run_is_correct_only_when_sound(cell, fault, tmp_path, monkeypatch):
    reg = Registry(tiny_checkout(tmp_path))
    _pin_budget_for(reg, cell, monkeypatch)
    _plant(fault, monkeypatch)
    line = harness.run_cell(reg, cell, 2**31 + 99, 0.5, False, torch.device("cpu"), time.perf_counter())
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["correct"] is (fault == "sound"), line["checks"]
    assert set(line["metrics"]) == {m["name"] for m in reg.end_to_end(cell)}
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}


def test_a_traced_run_reports_per_layer_metrics_and_a_breakdown(tmp_path):
    reg = Registry(tiny_checkout(tmp_path))
    cell = "scifact.bf16.window2"
    line = harness.run_cell(reg, cell, 12, 0.5, True, torch.device("cpu"), time.perf_counter())
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert line["correct"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(line["device"])
    # Without a card no device metric is written: only the host span reads.
    assert set(line["metrics"]) == {"dispatch_ms.qps"}
