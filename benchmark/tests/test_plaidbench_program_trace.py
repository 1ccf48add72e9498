"""The seven readers of the program's own trace (`plaidbench/program_trace.py`
and `metrics/<name>.py`): their numbers on synthetic records, None when the
records hold nothing, off the card, and from a program with no tracer; and
numbers from the records of real batches searched on the CPU."""

from __future__ import annotations

import sys

import numpy as np
import pytest

from conftest import ROOT
from plaidbench.registry import Registry

from nextplaid_tpu_torch.utils import trace

READERS = (
    "dispatch_copy_ms.qps", "result_wait_ms.qps", "result_build_ms.qps",
    "staged_select_prune_span_ms.qps", "staged_union_grid_span_ms.qps",
    "staged_union_live_pct.qps", "setup_kmeans_s.setup_s",
)
CARD = {"on_card": True}
_ids = iter(range(1, 10**6))


def _rec(kind, name, value, batch=None, parent=None, setup=False, id=None):
    return trace.Record(kind, name, float(value), batch, 0, 0,
                        next(_ids) if id is None else id, parent, 1, setup)


def _batch(b, copy, wait, build, build_child=0.0, staged=None):
    """One read batch's records: its spans and, with `staged`
    (select_prune ms, union_grid ms, live tokens, slots), the staged ones."""
    rid, bid = 1000 * b + 1, 1000 * b + 2
    recs = [
        _rec("span", "search.dispatch.copy", copy, b),
        _rec("span", "search.result", wait + build + 1, b, id=rid),
        _rec("span", "search.result.wait", wait, b, parent=rid),
        _rec("span", "search.result.build", build, b, parent=rid, id=bid),
    ]
    if build_child:
        recs.append(_rec("span", "search.dispatch", build_child, b + 500, parent=bid))
    if staged:
        sp, ug, live, slots = staged
        recs += [
            _rec("device", "staged.select_prune", sp, b),
            _rec("device", "staged.union_grid", ug, b),
            _rec("count", "staged.union_live_tokens", live, b),
            _rec("count", "staged.union_token_slots", slots, b),
        ]
    return recs


@pytest.fixture
def readers():
    reg = Registry(ROOT)
    return {name: reg.reader(name).read for name in READERS}


def _with(monkeypatch, recs):
    monkeypatch.setattr(trace, "records", lambda: list(recs))


def test_readers_on_synthetic_records(readers, monkeypatch):
    recs = [_rec("span", "build.kmeans", 90_000.0, setup=True),
            _rec("span", "build.kmeans", 120_500.0, setup=True),
            _rec("span", "build.codec", 5.0, setup=True)]
    recs += _batch(1, 2.0, 5.0, 3.0, staged=(40.0, 100.0, 600, 1000))
    recs += _batch(2, 4.0, 7.0, 9.0, build_child=4.0, staged=(42.0, 96.0, 300, 1000))
    # A batch dispatched but not read inside the records is left out.
    recs += [_rec("span", "search.dispatch.copy", 100.0, 3),
             _rec("device", "staged.union_grid", 1e3, 3)]
    _with(monkeypatch, recs)
    got = {name: read(CARD) for name, read in readers.items()}
    assert got == {
        "dispatch_copy_ms.qps": 3.0,
        "result_wait_ms.qps": 6.0,
        "result_build_ms.qps": 4.0,  # 3 and 9 - 4 (the fallback's own span)
        "staged_select_prune_span_ms.qps": 41.0,
        "staged_union_grid_span_ms.qps": 98.0,
        "staged_union_live_pct.qps": 45.0,
        "setup_kmeans_s.setup_s": 120.5,  # the latest build's
    }


def test_readers_find_nothing(readers, monkeypatch):
    _with(monkeypatch, [])
    assert {name: read(CARD) for name, read in readers.items()} == dict.fromkeys(READERS)
    # An exact route's batches: no staged records, no build.
    _with(monkeypatch, _batch(1, 2.0, 5.0, 3.0))
    got = {name: read(CARD) for name, read in readers.items()}
    assert [n for n, v in got.items() if v is None] == [
        "staged_select_prune_span_ms.qps", "staged_union_grid_span_ms.qps",
        "staged_union_live_pct.qps", "setup_kmeans_s.setup_s",
    ]


def test_readers_read_nothing_off_the_card_or_without_a_tracer(readers, monkeypatch):
    recs = _batch(1, 2.0, 5.0, 3.0, staged=(40.0, 100.0, 600, 1000))
    recs.append(_rec("span", "build.kmeans", 1.0, setup=True))
    _with(monkeypatch, recs)
    assert all(read({"on_card": False}) is None for read in readers.values())
    assert all(read({}) is None for read in readers.values())
    # A program without the tracer (an older checkout): the import fails.
    monkeypatch.setitem(sys.modules, "nextplaid_tpu_torch.utils.trace", None)
    assert all(read(CARD) is None for read in readers.values())


def test_readers_on_real_batches(readers, tmp_path):
    """Batches searched on the CPU while tracing is on: the search host's
    and the staged route's readers read numbers (stage marks are CUDA
    events, so the two device spans stay silent here)."""
    from nextplaid_tpu_torch.index import (
        DeviceIndex, IndexConfig, SearchParameters, create_index, search_batch_async,
    )

    rng = np.random.default_rng(3)
    docs = [rng.standard_normal((int(n), 16)).astype(np.float32) for n in rng.integers(4, 20, 80)]
    path = str(tmp_path / "idx")
    trace.clear()
    create_index(docs, path, IndexConfig(nbits=2, seed=1), device="cpu")
    index = DeviceIndex.load(path, device="cpu")
    params = SearchParameters(top_k=5, mode="staged", kernel="pallas", n_full_scores=32)
    with trace.recording():
        for _ in range(3):
            search_batch_async(index, docs[:6], params).result()
    got = {name: read(CARD) for name, read in readers.items()}
    trace.clear()
    assert got["staged_select_prune_span_ms.qps"] is None
    assert got["staged_union_grid_span_ms.qps"] is None
    for name in ("dispatch_copy_ms.qps", "result_wait_ms.qps", "result_build_ms.qps",
                 "setup_kmeans_s.setup_s"):
        assert got[name] > 0, name
    assert 0 < got["staged_union_live_pct.qps"] <= 100
