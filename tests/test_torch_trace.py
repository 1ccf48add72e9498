"""The port's tracer (`nextplaid_tpu_torch.utils.trace`) and its spans and
counters in the search host, the staged pipeline and the build.

Off, the exact and staged routes touch neither the profiler nor CUDA
events nor the ring; on (through `recording()` or a CPU profiler), each
batch's spans nest as the search host runs them, results are the same
bits, and the ring stays bounded. The card test holds the staged route's
device spans and union counters on an H100:
`python -m pytest --noconftest -m cuda tests/test_torch_trace.py`.
"""

from __future__ import annotations

import contextlib
from collections import deque

import numpy as np
import pytest
import torch

from nextplaid_tpu_torch.index import (
    DeviceIndex,
    IndexConfig,
    SearchParameters,
    create_index,
    create_index_from_device,
    search_batch_async,
)
from nextplaid_tpu_torch.index import search as S
from nextplaid_tpu_torch.utils import trace
from nextplaid_tpu_torch.utils.progress import with_progress

DIM = 32
STAGED = dict(top_k=10, mode="staged", kernel="pallas", n_ivf_probe=4, n_full_scores=64)
ROUTES = {
    "bf16_grid": dict(top_k=10, kernel="pallas"),
    "int8_grid": dict(top_k=10, kernel="pallas"),
    "staged": STAGED,
}
DISPATCH = ("search.dispatch.pad", "search.dispatch.copy", "search.dispatch.route")
RESULT = ("search.result.wait", "search.result.build")


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _corpus(rng, topics, n, lo, hi):
    return [
        _unit(topics[rng.integers(0, len(topics), k)]
              + 0.15 * rng.standard_normal((k, DIM))).astype(np.float32)
        for k in rng.integers(lo, hi, n)
    ]


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    topics = _unit(rng.standard_normal((16, DIM))).astype(np.float32)
    return _corpus(rng, topics, 200, 8, 41), _corpus(rng, topics, 12, 5, 33)


@pytest.fixture(scope="module")
def indexes(corpus, tmp_path_factory):
    docs, queries = corpus
    path = str(tmp_path_factory.mktemp("trace") / "idx")
    create_index(docs, path, IndexConfig(nbits=4, seed=42), device="cpu")
    plain = DeviceIndex.load(path, device="cpu")
    return {
        "bf16_grid": plain.with_token_grid(dtype="bf16"),
        "int8_grid": plain.with_token_grid(dtype="int8"),
        "staged": plain,
    }, queries


@pytest.fixture(autouse=True)
def empty_ring():
    trace.clear()
    yield
    trace.clear()


def _answers(results):
    return [(r.query_id, r.passage_ids, r.scores) for r in results]


def _run(index, queries, params, batches=1):
    return [
        search_batch_async(index, queries, SearchParameters(**params)).result()
        for _ in range(batches)
    ]


def _raise(*args, **kwargs):
    raise AssertionError("touched while tracing is off")


@pytest.mark.parametrize("route", ROUTES)
def test_off_the_routes_touch_no_profiler_event_or_ring(indexes, route, monkeypatch):
    idx, queries = indexes
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    monkeypatch.setattr(trace, "_append", _raise)
    monkeypatch.setattr(trace, "begin", _raise)
    monkeypatch.setattr(trace, "next_batch", _raise)
    assert not trace.active()
    (res,) = _run(idx[route], queries, ROUTES[route])
    assert len(res) == len(queries) and trace.records() == []


def _by_batch(recs):
    out = {}
    for r in recs:
        if r.batch is not None:
            out.setdefault(r.batch, []).append(r)
    return out


def _check_batch(recs, staged):
    spans = {r.name: r for r in recs if r.kind == "span"}
    names = sorted(r.name for r in recs if r.kind == "span")
    assert names == sorted(("search.dispatch", "search.result") + DISPATCH + RESULT)
    top_d, top_r = spans["search.dispatch"], spans["search.result"]
    for parent, children in ((top_d, DISPATCH), (top_r, RESULT)):
        for name in children:
            child = spans[name]
            assert child.parent == parent.id
            assert parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns
    assert top_d.end_ns <= top_r.start_ns
    counts = {r.name: r.value for r in recs if r.kind == "count"}
    if staged:
        assert set(counts) == {"staged.union_token_slots", "staged.union_live_tokens"}
        assert counts["staged.union_token_slots"] % 64 == 0
        assert 0 < counts["staged.union_live_tokens"] <= counts["staged.union_token_slots"]
    else:
        assert counts == {}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("switch", ["recording", "profiler"])
def test_on_each_batch_records_its_spans_once_nested(indexes, route, switch):
    idx, queries = indexes
    off = _run(idx[route], queries, ROUTES[route])
    if switch == "recording":
        with trace.recording():
            on = _run(idx[route], queries, ROUTES[route], batches=2)
    else:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            on = _run(idx[route], queries, ROUTES[route], batches=2)
        names = {e.name for e in prof.events()}
        assert {"search.dispatch", "search.result", *DISPATCH, *RESULT} <= names
    assert not trace.active()
    for res in on:
        assert _answers(res) == _answers(off[0])
    batches = _by_batch(trace.records())
    assert len(batches) == 2
    for recs in batches.values():
        _check_batch(recs, staged=route == "staged")


def test_refine_span_on_a_grid_only_batch(indexes, tmp_path):
    """A grid-only int8 index whose depth owes the host refine records
    `search.result.refine` under `search.result`."""
    from nextplaid_tpu_torch.index import load_grid_only

    _, queries = indexes
    path = str(tmp_path / "idx")
    docs = _corpus(np.random.default_rng(1), _unit(np.eye(DIM, dtype=np.float32)[:16]), 200, 8, 41)
    create_index(docs, path, IndexConfig(nbits=4, seed=42), device="cpu")
    grid = load_grid_only(path, device="cpu", refine="host")
    params = dict(top_k=10)
    off = _run(grid, queries, params)
    with trace.recording():
        on = _run(grid, queries, params)
    assert _answers(on[0]) == _answers(off[0])
    spans = {r.name: r for r in trace.records() if r.kind == "span"}
    assert spans["search.result.refine"].parent == spans["search.result"].id


def test_staged_overflow_fallback_nests_under_build(indexes):
    """A staged batch whose posting budget overflows falls back to an
    exhaustive search inside `search.result.build`: the fallback is a batch
    of its own, nested under the build."""
    idx, queries = indexes
    params = dict(STAGED, posting_budget=128)
    with trace.recording():
        (res,) = _run(idx["staged"], queries, params)
    recs = trace.records()
    build = [r for r in recs if r.name == "search.result.build"]
    assert len(build) == 2
    outer = max(build, key=lambda r: r.value)
    nested = [r for r in recs if r.name == "search.dispatch" and r.parent == outer.id]
    assert len(nested) == 1 and nested[0].batch != outer.batch
    assert outer.value >= nested[0].value
    assert len(res) == len(queries)


def test_ring_stays_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "_ring", deque(maxlen=8))
    for i in range(20):
        trace.count("c", i)
    recs = trace.records()
    assert len(recs) == 8 and [r.value for r in recs] == list(range(12, 20))
    assert trace.dropped() == 12
    trace.clear()
    assert trace.records() == [] and trace.dropped() == 0


def test_span_parents_and_device_spans_without_a_card():
    class Event:
        def __init__(self, t):
            self.t = t

        def elapsed_time(self, other):
            return other.t - self.t

    with trace.span("outer", batch=7):
        with trace.span("inner", batch=7):
            trace.device_span("dev", Event(1.0), Event(3.5), batch=7)
    dev, inner, outer = trace.records()
    assert (dev.kind, dev.value, dev.parent) == ("device", 2.5, inner.id)
    assert inner.parent == outer.id and outer.parent is None
    assert not inner.setup and outer.value >= inner.value >= 0


def _build_phases(recs):
    return [r.name for r in recs if r.setup and r.name.startswith("build.")]


@pytest.mark.parametrize("structure", ["auto", "rq"])
def test_builds_record_their_kmeans_and_still_report_progress(corpus, tmp_path, structure):
    docs, _ = corpus
    seen = []

    def progress(stage, processed=None, total=None):
        seen.append(stage)

    with with_progress(progress):
        create_index(docs, str(tmp_path / "a"),
                     IndexConfig(nbits=4, seed=42, centroid_structure=structure), device="cpu")
    assert seen == ["kmeans", "codec", "encode", "write"]
    assert _build_phases(trace.records()) == ["build.kmeans"]
    trace.clear()
    seen.clear()
    toks = torch.from_numpy(np.concatenate(docs))
    lens = [d.shape[0] for d in docs]
    with with_progress(progress):
        create_index_from_device(toks, lens, str(tmp_path / "b"),
                                 IndexConfig(nbits=2, seed=42, centroid_structure=structure), device="cpu")
    assert seen == ["kmeans", "codec", "encode", "ivf", "write"]
    (kmeans,) = trace.records()
    assert (kmeans.name, kmeans.setup, kmeans.parent) == ("build.kmeans", True, None)
    assert kmeans.value > 0 and not trace.active()


class _FakeEvent:
    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass


def test_marks_keep_their_stage_names(indexes, monkeypatch):
    """`search_pipeline(marks=[])` yields the stage names it always has,
    on the kernel and the scan stage 4, traced or not."""
    idx, queries = indexes
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    index = idx["staged"]
    arr, mask = S._pad_queries(queries, DIM)
    q_t, m_t = torch.from_numpy(arr), torch.from_numpy(mask)
    want = {
        "pallas": ["start", "stage12", "stage3", "stage3b", "union", "stage4_grid",
                   "stage4_kernel", "stage5"],
        "xla": ["start", "stage12", "stage3", "stage3b", "union", "stage4_scan", "stage5"],
    }
    for kernel, names in want.items():
        params = SearchParameters(**dict(STAGED, kernel=kernel, approx_score="codes"))
        shapes = S.PipelineShapes.derive(index, params, len(queries), arr.shape[1])
        for tracing in (False, True):
            marks = []
            with trace.recording() if tracing else contextlib.nullcontext():
                S.search_pipeline(index, q_t, m_t, None, shapes, marks=marks)
            assert [m[0] for m in marks] == names


class _TimedEvent:
    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t


@pytest.mark.parametrize("stage4", ["stage4_kernel", "stage4_scan"])
def test_result_turns_marks_into_stage_spans(stage4):
    """A traced staged batch's marks become its device spans, each between
    its two marks, on the kernel and on the scan stage 4."""
    names = ["start", "stage12", "stage3", "stage3b", "union"]
    names += ["stage4_grid", stage4] if stage4 == "stage4_kernel" else [stage4]
    marks = [(n, _TimedEvent(float(i * i))) for i, n in enumerate(names + ["stage5"])]
    S.PendingSearch(None, [], None, None, 0, None, None, batch=5, marks=marks)._record(
        {"staged.union_token_slots": 64}
    )
    t = dict((n, e.t) for n, e in marks)
    want = [("staged.select_prune", t["union"] - t["start"])]
    if stage4 == "stage4_kernel":
        want += [("staged.union_grid", t["stage4_grid"] - t["union"])]
    recs = trace.records()
    assert [(r.name, r.value) for r in recs if r.kind == "device"] == want
    assert [(r.name, r.value, r.batch) for r in recs if r.kind == "count"] == [
        ("staged.union_token_slots", 64.0, 5)
    ]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: stage marks are CUDA events")
    return torch.device("cuda")


@pytest.mark.cuda
def test_staged_device_spans_on_the_card(corpus, tmp_path, cuda, monkeypatch):
    """On the card the staged route's device spans resolve to positive ms
    from events already complete (reading them adds no wait), and the
    union's live counters stay within its slots."""
    docs, queries = corpus
    path = str(tmp_path / "idx")
    create_index(docs, path, IndexConfig(nbits=4, seed=42), device=cuda)
    index = DeviceIndex.load(path, device=cuda)
    params = dict(STAGED, kernel="auto")
    off = _run(index, queries, params)
    device_span = trace.device_span
    complete = []

    def checked(name, a, b, batch=None):
        complete.append(a.query() and b.query())
        device_span(name, a, b, batch)

    monkeypatch.setattr(trace, "device_span", checked)
    with trace.recording():
        on = _run(index, queries, params, batches=3)
    for res in on:
        assert _answers(res) == _answers(off[0])
    assert complete and all(complete)
    for recs in _by_batch(trace.records()).values():
        dev = {r.name: r.value for r in recs if r.kind == "device"}
        assert set(dev) == {"staged.select_prune", "staged.union_grid"}
        assert all(v > 0 for v in dev.values())
        _check_batch(recs, staged=True)
