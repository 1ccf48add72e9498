"""DeviceIndex.append_batch, capacity growth and the stale-IVF reroute, held
against a reload of the directory and against the JAX package's append.

The JAX package appends functionally; the port writes the batch into the
capacity rows in place (see `DeviceIndex.append_batch`). Both must leave the
same padded arrays: codes, residuals, doclens and doc offsets equal, the bf16
grid within one bf16 rounding step, the int8 grid within one int8 step with
equal scales (compared in the JAX package's interleaved layout), and the same
capacities after any sequence of appends. Searches on an appended index
return what a fresh reload returns (ids equal, scores within 1e-4), and an
index object from before an append keeps answering for its own documents.
"""

import logging
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nextplaid_tpu.index as J
from nextplaid_tpu.index.update import update_index as jax_update_index
from nextplaid_tpu_torch.index import (
    DeviceIndex,
    SearchParameters,
    load_grid_only,
    search_batch,
    search_batch_async,
)
from nextplaid_tpu_torch.index import container as C
from nextplaid_tpu_torch.index.container import int8_grid_to_interleaved, pin_outcome, pin_settings
from nextplaid_tpu_torch.index.update import update_index
from nextplaid_tpu_torch.utils.errors import UpdateError
from tests.test_torch_search import _assert_same_topk

CPU = "cpu"
DIM = 16
TOL = 1e-4
EXACT = dict(top_k=5, mode="exact")


def _unit(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    topics = _unit(rng.standard_normal((24, DIM)).astype(np.float32))
    docs = []
    for _ in range(220):
        n = int(rng.integers(6, 14))
        t = topics[rng.integers(0, 24, size=n)]
        docs.append(_unit(t + 0.15 * rng.standard_normal((n, DIM))).astype(np.float32))
    qrng = np.random.default_rng(3)
    queries = [
        _unit(topics[qrng.integers(0, 24, size=5)] + 0.1 * qrng.standard_normal((5, DIM))).astype(np.float32)
        for _ in range(8)
    ]
    return docs, queries


@pytest.fixture(scope="module")
def bases(corpus, tmp_path_factory):
    """Indexes of the first 60 and 180 docs, built by the JAX package."""
    docs, _ = corpus
    out = {}
    for n in (60, 180):
        path = str(tmp_path_factory.mktemp(f"base{n}") / "idx")
        J.create_index(docs[:n], path, J.IndexConfig(nbits=4, seed=42))
        out[n] = path
    return out


@pytest.fixture
def copy_of(bases, tmp_path):
    def make(n):
        path = str(tmp_path / f"idx{n}")
        shutil.copytree(bases[n], path)
        return path

    return make


def _encode(path, docs):
    """Disk append through the port's update_index (centroids kept); the
    encoded batch for append_batch."""
    info = {}
    update_index(docs, path, update_threshold=False, info_out=info, device=CPU)
    return info["encoded"]


def _pin(index, pin):
    """Pin `index` (either package's) as `pin` says."""
    return index if pin == "none" else index.with_token_grid(budget_mb=10_000, dtype=pin)


@pytest.mark.parametrize("kernel", ["auto", "pallas"])
@pytest.mark.parametrize("pin", ["bf16", "int8", "none"])
def test_append_parity_vs_reload(corpus, copy_of, pin, kernel):
    docs, queries = corpus
    path = copy_of(180)
    served = _pin(DeviceIndex.load(path, device=CPU), pin)
    appended = served.append_batch(*_encode(path, docs[180:]))
    assert appended is not None and appended.ivf_stale
    assert appended.num_documents == 220
    assert appended.num_embeddings == sum(d.shape[0] for d in docs)
    fresh = _pin(DeviceIndex.load(path, device=CPU), pin)
    params = SearchParameters(kernel=kernel, **EXACT)
    for a, b in zip(search_batch(appended, queries, params), search_batch(fresh, queries, params)):
        assert a.passage_ids == b.passage_ids
        np.testing.assert_allclose(a.scores, b.scores, rtol=TOL, atol=TOL)
    # An appended doc is found by its own tokens.
    hit = search_batch(appended, [docs[180][:5]], params)[0]
    assert hit.passage_ids[0] == 180


def _jax_arrays(index):
    return {n: np.asarray(getattr(index, n)) for n in ("codes", "residuals", "doclens", "doc_offsets")}


def _assert_same_state(ours, ref, pin):
    """Padded arrays and grids of the port's index equal the JAX one's."""
    assert ours.num_documents == ref.num_documents
    assert ours.num_embeddings == ref.num_embeddings
    assert ours.num_docs_padded == ref.num_docs_padded
    assert ours.max_doclen == ref.max_doclen
    for name, want in _jax_arrays(ref).items():
        got = getattr(ours, name).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    if pin == "none":
        assert ours.token_grid is None and ref.token_grid is None
        return
    assert ours.grid_token_axis() == ref.grid_token_axis()
    assert ours.grid_doc_rows() == ref.grid_doc_rows()
    if pin == "bf16":
        want = np.asarray(ref.token_grid.astype(jnp.float32))
        got = ours.token_grid.float().numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=2**-7, atol=1e-6)
        assert (got == want).mean() > 0.999
        return
    grid_i, scales_i = int8_grid_to_interleaved(ours.token_grid, ours.token_scales)
    want = torch.from_numpy(np.array(ref.token_grid))
    assert grid_i.shape == want.shape
    diff = (grid_i.int() - want.int()).abs()
    assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) > 0.999
    want_s = torch.from_numpy(np.asarray(ref.token_scales.astype(jnp.float32))).to(torch.bfloat16)
    assert torch.equal(scales_i, want_s)


@pytest.mark.parametrize("capacity", [1.0, 1.5])
@pytest.mark.parametrize("pin", ["bf16", "int8", "none"])
def test_append_matches_jax_append(corpus, copy_of, pin, capacity):
    """Both packages load the same directory (with the same headroom) and
    append the same encoded batch."""
    docs, _ = corpus
    path = copy_of(180)
    ours = _pin(DeviceIndex.load(path, capacity_factor=capacity, device=CPU), pin)
    ref = _pin(J.DeviceIndex.load(path, capacity_factor=capacity), pin)
    _assert_same_state(ours, ref, pin)
    info = {}
    jax_update_index(docs[180:], path, update_threshold=False, info_out=info)
    ours = ours.append_batch(*info["encoded"])
    ref = ref.append_batch(*info["encoded"])
    _assert_same_state(ours, ref, pin)


@pytest.mark.parametrize("pin", ["bf16", "int8"])
def test_capacity_growth_shapes_match_jax(corpus, copy_of, pin):
    """Four appends of 40 docs onto 60: each grows (the batch pads to 256
    doc rows), and after each the capacities and arrays equal the JAX
    package's."""
    docs, queries = corpus
    path = copy_of(60)
    ours = _pin(DeviceIndex.load(path, device=CPU), pin)
    ref = _pin(J.DeviceIndex.load(path), pin)
    shapes = []
    for s in range(60, 220, 40):
        info = {}
        jax_update_index(docs[s : s + 40], path, update_threshold=False, info_out=info)
        ours = ours.append_batch(*info["encoded"])
        ref = ref.append_batch(*info["encoded"])
        assert (ours.num_docs_padded, ours.codes.shape[0]) == (ref.num_docs_padded, ref.codes.shape[0])
        shapes.append(ours.num_docs_padded)
        _assert_same_state(ours, ref, pin)
    assert shapes == sorted(shapes) and shapes[-1] > shapes[0] > 64
    fresh = _pin(DeviceIndex.load(path, device=CPU), pin)
    for a, b in zip(search_batch(ours, queries, SearchParameters(**EXACT)),
                    search_batch(fresh, queries, SearchParameters(**EXACT))):
        assert a.passage_ids == b.passage_ids


def test_load_capacity_shapes_match_jax(bases):
    for capacity, aware in ((1.0, False), (1.5, False), (2.0, True)):
        ours = DeviceIndex.load(bases[180], capacity_factor=capacity, grid_aware_capacity=aware, device=CPU)
        ref = J.DeviceIndex.load(bases[180], capacity_factor=capacity, grid_aware_capacity=aware)
        assert ours.num_docs_padded == ref.num_docs_padded
        assert ours.codes.shape[0] == ref.codes.shape[0]
        assert ours.ivf_doc_ids.shape[0] == ref.ivf_doc_ids.shape[0]
        np.testing.assert_array_equal(ours.ivf_doc_ids.numpy(), np.asarray(ref.ivf_doc_ids))


@pytest.mark.parametrize(
    "case",
    [
        # (n_docs, max_doclen, dim, requested, budget_mb, dtype)
        (1000, 32, 128, 1.5, 8, "bf16"),
        (1000, 32, 128, 1.5, 1000, "bf16"),
        (1000, 32, 128, 1.5, 8, "auto"),
        (1000, 32, 128, 1.5, 12, "int8"),
        (0, 0, 128, 1.5, None, None),
        (1000, 32, 128, 1.0, None, None),
        (5183, 300, 128, 1.5, 4096, "auto"),
        (5183, 300, 128, 1.5, 900, "bogus"),
    ],
)
def test_plan_capacity_factor_matches_jax(case, caplog):
    with caplog.at_level(logging.WARNING):
        ours = DeviceIndex.plan_capacity_factor(*case)
    warned = any("append headroom" in r.getMessage() for r in caplog.records)
    assert ours == J.DeviceIndex.plan_capacity_factor(*case)
    assert warned == (ours == 1.0 and case[3] > 1.0 and case[0] > 0)


MB = 1 << 20


@pytest.mark.parametrize(
    "case",
    [
        # (bf16 bytes, int8 bytes, budget MB, dtype, outcome)
        (MB, MB // 2, 1, "auto", "bf16"),
        (MB + 1, MB, 1, "auto", "int8"),
        (MB + 1, MB + 1, 1, "auto", "none"),
        (0, 0, 0, "auto", "bf16"),
        (MB, MB // 2, 1, "bf16", "bf16"),
        (MB + 1, MB // 2, 1, "bf16", "none"),
        (MB // 2, MB // 4, 1, "int8", "int8"),
        (MB + 1, MB, 1, "int8", "int8"),
        (MB + 1, MB + 1, 1, "int8", "none"),
        (MB + 1, MB, 1, "bogus", "int8"),
    ],
)
def test_pin_outcome(case):
    *args, want = case
    assert pin_outcome(*args) == want


@pytest.mark.parametrize("default", ["auto", "int8"])
def test_pin_settings_take_arguments_then_environment(default, monkeypatch):
    monkeypatch.delenv("NEXT_PLAID_PIN_BUDGET_MB", raising=False)
    monkeypatch.delenv("NEXT_PLAID_PIN_DTYPE", raising=False)
    assert pin_settings(default_dtype=default) == (4096, default)
    monkeypatch.setenv("NEXT_PLAID_PIN_BUDGET_MB", "12")
    monkeypatch.setenv("NEXT_PLAID_PIN_DTYPE", "bf16")
    assert pin_settings(default_dtype=default) == (12, "bf16")
    assert pin_settings(0, "int8", default_dtype=default) == (0, "int8")
    assert pin_settings(7, default_dtype=default) == (7, "bf16")


@pytest.mark.parametrize("dtype", ["auto", "bf16", "int8"])
def test_with_token_grid_and_plan_agree(bases, dtype, monkeypatch, caplog):
    """At budgets either side of each dtype's bytes, of a load without
    headroom and of one with 1.5x: `with_token_grid` pins as `pin_outcome`
    says, and `plan_capacity_factor` keeps the headroom exactly where both
    loads pin alike, naming the two outcomes where it drops it. Grid bytes
    are scaled 100x (both read `_grid_bytes_for`) so that MB budgets fall
    between them."""
    real = C._grid_bytes_for
    monkeypatch.setattr(C, "_grid_bytes_for", lambda *a: 100 * real(*a))
    plain = DeviceIndex.load(bases[60], device=CPU)
    roomy = DeviceIndex.load(bases[60], capacity_factor=1.5, device=CPU)
    sizes = [index.grid_bytes(dt) >> 20 for index in (plain, roomy) for dt in ("bf16", "int8")]
    budgets = sorted({mb + side for mb in sizes for side in (0, 1)})

    def pinned(index, budget):
        out = index.with_token_grid(budget_mb=budget, dtype=dtype)
        return "none" if out.token_grid is None else ("int8" if out.grid_is_int8 else "bf16")

    alike = set()
    for budget in budgets:
        a, b = pinned(plain, budget), pinned(roomy, budget)
        assert a == pin_outcome(plain.grid_bytes("bf16"), plain.grid_bytes("int8"), budget, dtype)
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="nextplaid_tpu_torch.index.container"):
            factor = DeviceIndex.plan_capacity_factor(
                plain.num_documents, plain.max_doclen, plain.dim, 1.5, budget, dtype)
        assert (factor == 1.5) == (a == b)
        assert (f"from {a} to {b}" in caplog.text) == (a != b)
        alike.add(a == b)
    assert alike == {True, False}


def test_grow_warns_when_grid_dropped(bases, monkeypatch, caplog):
    idx = DeviceIndex.load(bases[60], device=CPU).with_token_grid(dtype="bf16")
    assert idx.token_grid is not None
    monkeypatch.setenv("NEXT_PLAID_PIN_BUDGET_MB", "0")
    with caplog.at_level(logging.WARNING, logger="nextplaid_tpu_torch.index.container"):
        grown = idx._grow(doc_capacity=idx.num_docs_padded * 2, token_capacity=idx.codes.shape[0] * 2)
    assert grown.token_grid is None
    assert grown.num_docs_padded == _round8(idx.num_docs_padded * 2)
    assert any("dropped the pinned token grid" in r.getMessage() for r in caplog.records)


def _round8(x):
    return (x + 7) // 8 * 8


def test_grow_downgrades_bf16_to_int8(bases, monkeypatch, caplog):
    """A grown bf16 grid over the budget takes the auto path: int8, with its
    precision warning."""
    idx = DeviceIndex.load(bases[60], device=CPU).with_token_grid(dtype="bf16")
    rows = idx.num_docs_padded * 2
    # A 1 MB budget that the grown bf16 grid exceeds and the int8 one fits.
    monkeypatch.setenv("NEXT_PLAID_PIN_BUDGET_MB", "1")
    monkeypatch.setattr(DeviceIndex, "grid_bytes", lambda self, dtype="bf16": (2 << 20) if dtype == "bf16" else 0)
    with caplog.at_level(logging.WARNING):
        grown = idx._grow(doc_capacity=rows, token_capacity=idx.codes.shape[0] * 2)
    assert grown.grid_is_int8
    assert any("falling back to int8" in r.getMessage() for r in caplog.records)


def test_stale_ivf_reroutes_to_exhaustive(corpus, copy_of, caplog):
    """A staged request on an appended (stale) index is answered by the
    exhaustive scan, with the JAX package's warning, as the JAX package
    answers it."""
    docs, queries = corpus
    path = copy_of(180)
    ours0 = DeviceIndex.load(path, device=CPU)
    ref0 = J.DeviceIndex.load(path)
    info = {}
    jax_update_index(docs[180:], path, update_threshold=False, info_out=info)
    ours, ref = ours0.append_batch(*info["encoded"]), ref0.append_batch(*info["encoded"])
    assert ours.ivf_stale and ref.ivf_stale
    staged = dict(top_k=5, mode="staged")
    with caplog.at_level(logging.WARNING):
        pending = search_batch_async(ours, queries, SearchParameters(**staged))
    assert pending.shapes is None  # the exact route
    assert any(
        r.getMessage() == "IVF is stale after device appends; routing to exhaustive "
        "search (call DeviceIndex.refresh_ivf to restore staged mode)"
        for r in caplog.records
    )
    got = pending.result()
    want = J.search_batch(ref, queries, J.SearchParameters(**staged))
    _assert_same_topk(got, want, k=5)
    fresh = search_batch(DeviceIndex.load(path, device=CPU), queries, SearchParameters(**EXACT))
    for a, b in zip(got, fresh):
        assert a.passage_ids == b.passage_ids


def test_staged_search_after_refresh_ivf(corpus, copy_of, caplog):
    docs, queries = corpus
    path = copy_of(180)
    appended = DeviceIndex.load(path, device=CPU).append_batch(*_encode(path, docs[180:]))
    refreshed = appended.refresh_ivf(path)
    assert appended.ivf_stale and not refreshed.ivf_stale
    params = SearchParameters(top_k=5, mode="staged", n_ivf_probe=8, stage1_precision="highest")
    with caplog.at_level(logging.WARNING):
        pending = search_batch_async(refreshed, queries, params)
    assert pending.shapes is not None
    assert not any("IVF is stale" in r.getMessage() for r in caplog.records)
    got = pending.result()
    want = search_batch(DeviceIndex.load(path, device=CPU), queries, params)
    for a, b in zip(got, want):
        assert a.passage_ids == b.passage_ids
        np.testing.assert_allclose(a.scores, b.scores, rtol=TOL, atol=TOL)
    ref = J.DeviceIndex.load(path)
    _assert_same_topk(got, J.search_batch(ref, queries, J.SearchParameters(
        top_k=5, mode="staged", n_ivf_probe=8, stage1_precision="highest")), k=5)


@pytest.mark.parametrize("pin", ["bf16", "int8", "none"])
def test_pre_append_object_keeps_its_answer(corpus, copy_of, pin):
    """In-place appends share tensors with the old object: a search on it,
    enqueued before or after the append, still returns the pre-append
    answer; a second append on it raises."""
    docs, queries = corpus
    path = copy_of(180)
    # Headroom for 40 docs: the batch pads to 256 doc rows.
    served = _pin(DeviceIndex.load(path, capacity_factor=2.5, device=CPU), pin)
    # Queries that the new docs would win.
    probes = queries + [d[:5] for d in docs[180:186]]
    params = SearchParameters(kernel="pallas", **EXACT)
    before = search_batch(served, probes, params)
    pending = search_batch_async(served, probes, params)
    encoded = _encode(path, docs[180:])
    appended = served.append_batch(*encoded)
    assert appended.codes.data_ptr() == served.codes.data_ptr()  # written in place
    after_pending = pending.result()
    after = search_batch(served, probes, params)
    for res in (after_pending, after):
        for a, b in zip(res, before):
            assert a.passage_ids == b.passage_ids and all(i < 180 for i in a.passage_ids)
            np.testing.assert_allclose(a.scores, b.scores, rtol=0, atol=0)
    assert search_batch(appended, [docs[181][:5]], params)[0].passage_ids[0] == 181
    with pytest.raises(UpdateError, match="successor"):
        served.append_batch(*encoded)


@pytest.mark.parametrize("sibling", ["pre_pin", "pre_refresh"])
def test_sibling_of_appended_index_refuses_append(corpus, copy_of, sibling):
    """Objects made beside one another by `with_token_grid` or `refresh_ivf`
    share the appended tensors: once one of them has appended, the other
    (at the older count) raises instead of writing over the successor's
    rows, and the successor keeps serving its documents."""
    docs, _ = corpus
    path = copy_of(180)
    loaded = DeviceIndex.load(path, capacity_factor=2.5, device=CPU)
    served = loaded.with_token_grid(budget_mb=10_000, dtype="bf16")
    first = served.append_batch(*_encode(path, docs[180:200]))
    second_batch = _encode(path, docs[200:])
    if sibling == "pre_pin":
        stale, newest = loaded, first
    else:
        stale, newest = first, first.refresh_ivf(path)
        newest = newest.append_batch(*second_batch)
        assert newest.num_documents == 220
    with pytest.raises(UpdateError, match="successor"):
        stale.append_batch(*second_batch)
    params = SearchParameters(kernel="pallas", **EXACT)
    for doc_id in (180, 199) + ((219,) if sibling == "pre_refresh" else ()):
        assert search_batch(newest, [docs[doc_id][:5]], params)[0].passage_ids[0] == doc_id
    fresh = DeviceIndex.load(path, device=CPU).with_token_grid(budget_mb=10_000, dtype="bf16")
    n = newest.num_documents
    assert torch.equal(newest.doclens[:n], fresh.doclens[:n])
    assert torch.equal(newest.codes[: newest.num_embeddings], fresh.codes[: newest.num_embeddings])


def test_append_validates_shapes(bases):
    served = DeviceIndex.load(bases[180], device=CPU)
    pd = served.residuals.shape[1]
    with pytest.raises(ValueError, match="disagree"):
        served.append_batch(np.zeros(5, np.int32), np.zeros((5, pd), np.uint8), np.asarray([3]))
    assert served.append_batch(np.zeros(0, np.int32), np.zeros((0, pd), np.uint8), np.zeros(0)) is served


def test_append_longer_than_td_returns_none(bases):
    """A doc one token longer than the grid's Td cannot go in place (None:
    the caller reloads); a doc of exactly Td does, untruncated."""
    pinned = DeviceIndex.load(bases[180], device=CPU).with_token_grid(dtype="bf16")
    td = pinned.grid_token_axis()
    pd = pinned.residuals.shape[1]
    codes = np.arange(td + 1, dtype=np.int32) % pinned.num_centroids
    res = np.full((td + 1, pd), 0x5A, np.uint8)
    assert pinned.append_batch(codes, res, np.asarray([td + 1])) is None
    out = pinned.append_batch(codes[:td], res[:td], np.asarray([td]))
    assert out is not None and out.grid_token_axis() == td and out.max_doclen == td
    row = out.token_grid[out.num_documents - 1].float()
    assert bool((row.abs().sum(dim=1) > 0).all())  # all Td rows written


def test_grid_only_append_raises(bases):
    go = load_grid_only(bases[180], dtype="int8", buckets=1, device=CPU)
    pd = go.residuals.shape[1]
    with pytest.raises(UpdateError, match="grid-only"):
        go.append_batch(np.zeros(3, np.int32), np.zeros((3, pd), np.uint8), np.asarray([3]))
    with pytest.raises(UpdateError, match="no IVF"):
        go.refresh_ivf(bases[180])


def test_from_host_defaults_keep_shapes(bases):
    """No capacity arguments: the padded shapes of PRs before appends."""
    ours = DeviceIndex.load(bases[180], device=CPU)
    ref = J.DeviceIndex.load(bases[180])
    assert ours.num_docs_padded == ref.num_docs_padded == _round8(181)
    assert ours.codes.shape[0] == ref.codes.shape[0]
    assert not ours.ivf_stale
