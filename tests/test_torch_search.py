"""The whole slice: build with the JAX package, carry the index state across
(from its arrays, and from disk), pin the bf16 grid and search in both
packages.

On the CPU the JAX package scores the pinned grid with its XLA scan
(`exact_all_scores`); the port runs its scan and, forced with
kernel="pallas", its kernel route (the plain version on the CPU). Scores
agree to rtol 1e-5, atol 1e-4 (f32 sums in other orders; |scores| < 40).
Top-10 lists are compared as id -> score maps: an id may be in one list
only if its score is within that tolerance of the 10th score, since
`lax.top_k` and `torch.topk` can break ties differently.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import nextplaid_tpu.index as J
from nextplaid_tpu.index.search import _pad_queries as jax_pad_queries
from nextplaid_tpu_torch.index import (
    DeviceIndex,
    SearchParameters,
    search_batch,
    search_batch_async,
    search_one,
)
from nextplaid_tpu_torch.index.search import _pad_queries

RTOL, ATOL = 1e-5, 1e-4
FAST = dict(top_k=10, stage1_precision="default")
ORACLE = dict(top_k=10, mode="exact", stage1_precision="highest")


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    rng = np.random.default_rng(0)
    dim = 32
    topics = _unit(rng.standard_normal((16, dim))).astype(np.float32)
    docs = []
    for _ in range(60):
        n = int(rng.integers(8, 41))
        t = topics[rng.integers(0, 16, n)] + 0.15 * rng.standard_normal((n, dim))
        docs.append(_unit(t).astype(np.float32))
    queries = []
    for _ in range(12):
        n = int(rng.integers(5, 33))
        t = topics[rng.integers(0, 16, n)] + 0.15 * rng.standard_normal((n, dim))
        queries.append(_unit(t).astype(np.float32))
    path = str(tmp_path_factory.mktemp("slice") / "idx")
    J.create_index(docs, path, J.IndexConfig(nbits=4, seed=42))
    ref = J.DeviceIndex.load(path)
    ref_pinned = ref.with_token_grid(budget_mb=10_000, dtype="bf16")
    assert ref_pinned.token_grid is not None
    return path, docs, queries, ref, ref_pinned


def _arrays(index):
    names = ("centroids", "codes", "residuals", "doc_offsets", "doclens",
             "ivf_offsets", "ivf_doc_ids", "bucket_cutoffs", "bucket_weights",
             "avg_residual")
    out = {n: np.asarray(getattr(index, n)) for n in names}
    if index.token_grid is not None:
        out["token_grid"] = np.asarray(index.token_grid.astype(jnp.float32))
    return out


def _carried(index):
    return DeviceIndex.from_reference_arrays(
        _arrays(index),
        nbits=index.nbits,
        max_doclen=index.max_doclen,
        num_documents=index.num_documents,
        num_embeddings=index.num_embeddings,
        device="cpu",
    )


def _assert_same_topk(ours, ref, k=10):
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        assert len(o.passage_ids) == len(r.passage_ids) == k
        np.testing.assert_allclose(o.scores, r.scores, rtol=RTOL, atol=ATOL)
        o_map = dict(zip(o.passage_ids, o.scores))
        r_map = dict(zip(r.passage_ids, r.scores))
        kth = r.scores[-1]
        for doc in set(o_map) ^ set(r_map):
            score = o_map.get(doc, r_map.get(doc))
            assert abs(score - kth) <= ATOL + RTOL * abs(kth), (doc, score, kth)
        for doc in set(o_map) & set(r_map):
            assert abs(o_map[doc] - r_map[doc]) <= ATOL + RTOL * abs(r_map[doc])


def _ours_pinned(built, source):
    path, _, _, ref, ref_pinned = built
    if source == "arrays":
        return _carried(ref_pinned)
    return DeviceIndex.load(path, device="cpu").with_token_grid(
        budget_mb=10_000, dtype="bf16"
    )


@pytest.mark.parametrize("source", ["arrays", "disk"])
@pytest.mark.parametrize("kernel", ["auto", "pallas"])
def test_pinned_search_matches_jax(built, source, kernel):
    _, _, queries, _, ref_pinned = built
    want = J.search_batch(ref_pinned, queries, J.SearchParameters(**FAST))
    got = search_batch(
        _ours_pinned(built, source), queries, SearchParameters(kernel=kernel, **FAST)
    )
    _assert_same_topk(got, want)


@pytest.mark.parametrize("source", ["arrays", "disk"])
def test_oracle_route_matches_jax(built, source):
    """The f32 "highest" decompress scan on the unpinned index."""
    path, _, queries, ref, _ = built
    ours = _carried(ref) if source == "arrays" else DeviceIndex.load(path, device="cpu")
    want = J.search_batch(ref, queries, J.SearchParameters(**ORACLE))
    _assert_same_topk(search_batch(ours, queries, SearchParameters(**ORACLE)), want)


def test_grid_built_by_port_matches_jax_grid(built):
    """bf16 grids decompressed by each package: equal up to one bf16
    rounding step of the f32 values they round (which agree to 1e-6)."""
    path, _, _, _, ref_pinned = built
    ours = _ours_pinned(built, "disk")
    want = np.asarray(ref_pinned.token_grid.astype(jnp.float32))
    got = ours.token_grid.float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2**-7, atol=1e-6)
    assert (got == want).mean() > 0.999


def test_kernel_route_matches_scan_route(built):
    _, _, queries, _, ref_pinned = built
    index = _carried(ref_pinned)
    _assert_same_topk(
        search_batch(index, queries, SearchParameters(kernel="pallas", **FAST)),
        search_batch(index, queries, SearchParameters(kernel="off", **FAST)),
    )


def test_subset_search_matches_jax(built):
    _, _, queries, _, ref_pinned = built
    subset = list(range(0, 60, 3))
    params = dict(top_k=5, stage1_precision="default")
    want = J.search_batch(ref_pinned, queries, J.SearchParameters(**params), subset=subset)
    got = search_batch(_carried(ref_pinned), queries,
                       SearchParameters(kernel="pallas", **params), subset=subset)
    _assert_same_topk(got, want, k=5)
    assert all(set(r.passage_ids) <= set(subset) for r in got)


def test_top_k_beyond_corpus_and_search_one(built):
    _, docs, queries, _, ref_pinned = built
    index = _carried(ref_pinned)
    (res,) = search_batch(index, queries[:1], SearchParameters(top_k=500))
    assert sorted(res.passage_ids) == list(range(len(docs)))
    one = search_one(index, queries[0], SearchParameters(**FAST))
    first = search_batch(index, queries[:1], SearchParameters(**FAST))[0]
    assert one.passage_ids == first.passage_ids


def test_async_matches_sync(built):
    _, _, queries, _, ref_pinned = built
    index = _carried(ref_pinned)
    params = SearchParameters(**FAST)
    pending = [search_batch_async(index, queries, params) for _ in range(3)]
    sync = search_batch(index, queries, params)
    for p in pending:
        assert [r.passage_ids for r in p.result()] == [r.passage_ids for r in sync]
    assert search_batch_async(index, [], params).result() == []


def test_pad_queries_matches_jax():
    rng = np.random.default_rng(0)
    queries = [rng.standard_normal((n, 16)).astype(np.float32) for n in (3, 33, 1)]
    for got, want in zip(_pad_queries(queries, 16), jax_pad_queries(queries, 16)):
        np.testing.assert_array_equal(got, want)


def test_unported_routes_raise(built):
    path, _, queries, ref, _ = built
    index = DeviceIndex.load(path, device="cpu")
    staged = SearchParameters(mode="auto", exact_max_embeddings=0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        search_batch(index, queries, staged)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        search_batch(index, queries, dataclasses.replace(staged, mode="staged"))
    # Over budget: unpinned, as in the JAX package.
    assert index.with_token_grid(budget_mb=0, dtype="bf16").token_grid is None
    # The JAX package's int8 grid (token-interleaved) carries across.
    ref8 = ref.with_token_grid(budget_mb=10_000, dtype="int8")
    int8 = dict(
        _arrays(ref),
        token_grid=np.asarray(ref8.token_grid),
        token_scales=np.asarray(ref8.token_scales.astype(jnp.float32)),
    )
    carried = DeviceIndex.from_reference_arrays(
        int8, nbits=ref.nbits, max_doclen=ref.max_doclen,
        num_documents=ref.num_documents, num_embeddings=ref.num_embeddings,
        device="cpu",
    )
    assert carried.grid_is_int8 and carried.token_grid.dtype.is_signed
    assert carried.grid_doc_rows() == ref8.grid_doc_rows()
    assert carried.grid_token_axis() == ref8.grid_token_axis()
