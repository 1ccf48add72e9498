"""The int8 and grid-only slice against the JAX package on the same index:
int8 pinning, the int8 scan and kernel routes, the bucketed-Td layout of
`load_grid_only`, and the refinement rerank.

The index is built once with the JAX package (`create_index_streamed`,
chunks of 48 docs, so the last chunk is ragged) from a numpy corpus with
doclens 8-200, and both packages load it from disk. Tolerances:
  - int8 grids built by the two packages: within one int8 step (the f32
    decompress sums in another order, so x / scale may round the other way
    at a tie), equal scales;
  - search over the same grid (the JAX grid carried across): scores to
    rtol 1e-5, atol 1e-4 (f32 sums in other orders), compared as id ->
    score maps with a tie tolerance at the k-th score;
  - refined grid-only search: ids and scores equal to the port's f32
    exhaustive oracle at rtol 1e-5, atol 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nextplaid_tpu.index as J
from nextplaid_tpu.index import container as jax_container
from nextplaid_tpu.index.build import DeviceChunk as JaxChunk
from nextplaid_tpu.index.build import create_index_streamed as jax_create_streamed
from nextplaid_tpu.index.exact import exact_search_split as jax_split
from nextplaid_tpu.index.search import _pad_queries
from nextplaid_tpu_torch.index import (
    DeviceIndex,
    SearchParameters,
    load_grid_only,
    search_batch,
)
from nextplaid_tpu_torch.index import container
from nextplaid_tpu_torch.index.container import (
    choose_bucket_tds,
    int8_grid_from_interleaved,
)
from nextplaid_tpu_torch.utils.errors import SearchError, StorageError

RTOL, ATOL = 1e-5, 1e-4
EXACT = dict(top_k=5, mode="exact")
FAST = dict(top_k=5, stage1_precision="default")
FORCE_BUCKETS = dict(buckets=3, bucket_min_gain=0.0, bucket_row_pad=0)


def _unit(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    rng = np.random.default_rng(7)
    dim = 32
    topics = _unit(rng.standard_normal((20, dim))).astype(np.float32)
    docs = []
    for _ in range(200):
        n = int(np.clip(rng.lognormal(3.6, 0.6), 8, 200))
        t = topics[rng.integers(0, 20, size=n)]
        docs.append(_unit(t + 0.2 * rng.standard_normal((n, dim))).astype(np.float32))

    def chunks():
        for s in range(0, len(docs), 48):  # 200 = 4*48 + 8: a ragged last chunk
            batch = docs[s : s + 48]
            yield JaxChunk(
                tokens=jnp.asarray(np.concatenate(batch)),
                doclens=np.asarray([d.shape[0] for d in batch], np.int64),
            )

    path = str(tmp_path_factory.mktemp("grid_only") / "idx")
    jax_create_streamed(
        chunks(), path, J.IndexConfig(nbits=2, seed=0),
        sample_tokens=jnp.asarray(np.concatenate(docs)),
        est_total_tokens=sum(d.shape[0] for d in docs),
    )
    queries = [d[:6] for d in docs[:8]]
    ref = J.DeviceIndex.load(path)
    ref_int8 = ref.with_token_grid(budget_mb=10_000, dtype="int8")
    assert ref_int8.token_scales is not None
    return path, docs, queries, ref, ref_int8


def _arrays(index):
    names = ("centroids", "codes", "residuals", "doc_offsets", "doclens",
             "ivf_offsets", "ivf_doc_ids", "bucket_cutoffs", "bucket_weights",
             "avg_residual")
    out = {n: np.asarray(getattr(index, n)) for n in names}
    f32 = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
    if index.token_grid is not None:
        grid = index.token_grid
        out["token_grid"] = np.asarray(grid) if grid.dtype == jnp.int8 else f32(grid)
    if index.token_scales is not None:
        out["token_scales"] = f32(index.token_scales)
    if index.grid_buckets:
        out["grid_buckets"] = [
            np.asarray(g) if g.dtype == jnp.int8 else f32(g) for g in index.grid_buckets
        ]
        out["scale_buckets"] = [f32(s) for s in index.scale_buckets]
        out["grid_perm"] = np.asarray(index.grid_perm)
        out["grid_doclens"] = np.asarray(index.grid_doclens)
    return out


def _carried(index):
    return DeviceIndex.from_reference_arrays(
        _arrays(index),
        nbits=index.nbits,
        max_doclen=index.max_doclen,
        num_documents=index.num_documents,
        num_embeddings=index.num_embeddings,
        device="cpu",
        grid_only=index.grid_only,
    )


def _results(ids, scores):
    return [
        J.QueryResult(
            query_id=i,
            passage_ids=[int(x) for x in ids[i] if x >= 0],
            scores=[float(s) for x, s in zip(ids[i], scores[i]) if x >= 0],
        )
        for i in range(ids.shape[0])
    ]


def _assert_same_topk(ours, ref, rtol=RTOL, atol=ATOL):
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        assert len(o.passage_ids) == len(r.passage_ids)
        np.testing.assert_allclose(o.scores, r.scores, rtol=rtol, atol=atol)
        o_map = dict(zip(o.passage_ids, o.scores))
        r_map = dict(zip(r.passage_ids, r.scores))
        kth = r.scores[-1]
        for doc in set(o_map) ^ set(r_map):
            score = o_map.get(doc, r_map.get(doc))
            assert abs(score - kth) <= atol + rtol * abs(kth), (doc, score, kth)
        for doc in set(o_map) & set(r_map):
            assert abs(o_map[doc] - r_map[doc]) <= atol + rtol * abs(r_map[doc])


def _assert_grid_close(ours, scales, ref_grid, ref_scales):
    """Port int8 grid vs the JAX one (un-interleaved): one int8 step, equal
    scales."""
    want, want_s = int8_grid_from_interleaved(
        torch.from_numpy(np.array(ref_grid)),
        torch.from_numpy(np.array(ref_scales.astype(jnp.float32))).to(torch.bfloat16),
    )
    assert ours.shape == want.shape and ours.dtype == torch.int8
    diff = (ours.int() - want.int()).abs()
    assert int(diff.max()) <= 1
    assert float((diff == 0).float().mean()) > 0.999
    assert torch.equal(scales, want_s)


def test_int8_grid_matches_jax(built):
    path, _, _, _, ref_int8 = built
    ours = DeviceIndex.load(path, device="cpu").with_token_grid(budget_mb=10_000, dtype="int8")
    assert ours.grid_is_int8 and ours.token_grid.dtype == torch.int8
    assert ours.grid_token_axis() == ref_int8.grid_token_axis()
    assert ours.grid_doc_rows() == ref_int8.grid_doc_rows()
    _assert_grid_close(ours.token_grid, ours.token_scales,
                       ref_int8.token_grid, ref_int8.token_scales)
    assert (ours.token_scales[: ours.num_docs_padded].float().amax(1) > 0).sum() == ours.num_documents


def test_int8_scan_matches_jax(built):
    """The XLA/torch tile scan over the int8 grid (queries unquantized)."""
    _, _, queries, _, ref_int8 = built
    want = J.search_batch(ref_int8, queries, J.SearchParameters(**FAST))
    got = search_batch(_carried(ref_int8), queries, SearchParameters(kernel="off", **FAST))
    _assert_same_topk(got, want)


def test_int8_kernel_route_matches_jax(built):
    """Forced kernel route (int8 queries; the plain version on the CPU)
    against the JAX kernel route in interpret mode."""
    _, _, queries, _, ref_int8 = built
    q_arr, _ = _pad_queries(queries, ref_int8.dim)
    ids, scores = jax_split(ref_int8, jnp.asarray(q_arr), None, top_k=5, has_subset=False)
    want = _results(np.asarray(ids), np.asarray(scores))
    got = search_batch(_carried(ref_int8), queries, SearchParameters(kernel="pallas", **FAST))
    _assert_same_topk(got, want)


def test_int8_auto_fallback_matches_jax(built, caplog):
    """dtype='auto' picks bf16 when it fits, int8 (with a warning) when only
    int8 fits, nothing when neither fits; the same as the JAX package."""
    path, _, _, ref, _ = built
    ours = dataclasses.replace(DeviceIndex.load(path, device="cpu"), max_doclen=290)
    theirs = dataclasses.replace(ref, max_doclen=290)
    for dtype in ("bf16", "int8"):
        assert ours.grid_bytes(dtype) == theirs.grid_bytes(dtype)
    bf16_mb = ours.grid_bytes("bf16") >> 20
    int8_mb = ours.grid_bytes("int8") >> 20
    assert int8_mb < bf16_mb
    big = ours.with_token_grid(budget_mb=bf16_mb + 2, dtype="auto")
    assert big.token_grid.dtype == torch.bfloat16
    with caplog.at_level("WARNING"):
        mid = ours.with_token_grid(budget_mb=int8_mb + 1, dtype="auto")
    assert mid.token_grid.dtype == torch.int8 and mid.token_scales is not None
    assert "falling back to int8" in caplog.text
    assert theirs.with_token_grid(budget_mb=int8_mb + 1, dtype="auto").token_grid.dtype == jnp.int8
    assert ours.with_token_grid(budget_mb=0, dtype="auto").token_grid is None


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mult", [8, 32, 128])
def test_choose_bucket_tds_matches_jax(seed, mult):
    rng = np.random.default_rng(seed)
    lens = [
        np.clip(rng.lognormal(5.0, 0.35, 3000), 20, 300),
        rng.integers(100, 221, 2000),
        np.clip(rng.lognormal(3.6, 0.6, 500), 8, 200),
    ][seed].astype(np.int64)
    for max_buckets, gain, pad in ((4, 0.08, 128), (3, 0.0, 0), (1, 0.08, 128)):
        assert choose_bucket_tds(lens, mult, max_buckets, gain, pad) == (
            jax_container.choose_bucket_tds(lens, mult, max_buckets, gain, pad)
        )
    assert choose_bucket_tds(np.zeros(0, np.int64), mult, 4) == [mult]


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("buckets", [1, 3])
def test_load_grid_only_layout_matches_jax(built, dtype, buckets):
    """Same row geometry, grid_perm and grid_doclens as the JAX package's
    grid-only load; grids equal (bf16) or within one int8 step."""
    path, _, _, _, _ = built
    kw = FORCE_BUCKETS if buckets > 1 else dict(buckets=1)
    ref = J.load_grid_only(path, dtype=dtype, refine=False, **kw)
    ours = load_grid_only(path, dtype=dtype, refine=False, device="cpu", **kw)
    assert ours.grid_only and ours.codes.shape[0] == 0 and ours.refine_side == "none"
    assert ours.num_documents == ref.num_documents
    assert ours.num_embeddings == ref.num_embeddings
    if buckets == 1:
        pairs = [(ours.token_grid, ours.token_scales, ref.token_grid, ref.token_scales)]
        assert not ours.grid_buckets
    else:
        assert len(ours.grid_buckets) == len(ref.grid_buckets) >= 2
        np.testing.assert_array_equal(ours.grid_perm.numpy(), np.asarray(ref.grid_perm))
        np.testing.assert_array_equal(
            ours.grid_doclens.numpy(), np.asarray(ref.grid_doclens).reshape(-1)
        )
        scales = ours.scale_buckets or [None] * len(ours.grid_buckets)
        ref_scales = ref.scale_buckets or [None] * len(ref.grid_buckets)
        pairs = list(zip(ours.grid_buckets, scales, ref.grid_buckets, ref_scales))
    for grid, sc, ref_grid, ref_sc in pairs:
        if dtype == "int8":
            _assert_grid_close(grid, sc, ref_grid, ref_sc)
        else:
            want = np.asarray(ref_grid.astype(jnp.float32))
            assert grid.shape == want.shape
            np.testing.assert_allclose(grid.float().numpy(), want, rtol=2**-7, atol=1e-6)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_bucketed_search_matches_jax(built, dtype):
    """The bucketed kernel route over the JAX grid carried across, with and
    without a subset, against the JAX package's split search."""
    path, _, queries, _, _ = built
    ref = J.load_grid_only(path, dtype=dtype, refine=False, **FORCE_BUCKETS)
    ours = _carried(ref)
    assert len(ours.grid_buckets) >= 2 and ours.grid_only
    q_arr, _ = _pad_queries(queries, ref.dim)
    subset = list(range(0, 200, 3))
    mask = np.zeros(ref.num_docs_padded, bool)
    mask[subset] = True
    for sub, sub_mask in ((None, None), (subset, jnp.asarray(mask))):
        ids, scores = jax_split(ref, jnp.asarray(q_arr), sub_mask, top_k=5,
                                has_subset=sub is not None)
        want = _results(np.asarray(ids), np.asarray(scores))
        got = search_batch(ours, queries, SearchParameters(**FAST), subset=sub)
        _assert_same_topk(got, want)
        if sub is not None:
            assert all(set(r.passage_ids) <= set(sub) for r in got)


@pytest.mark.parametrize("buckets", [1, 3])
def test_refine_matches_f32_oracle(built, buckets):
    """Refinement on the device (auto), on the host and off: refined ids and
    scores equal the port's f32 exhaustive oracle, and the two sides agree;
    unrefined scores are the int8 kernel's."""
    path, _, queries, _, _ = built
    kw = FORCE_BUCKETS if buckets > 1 else dict(buckets=1)
    oracle = search_batch(DeviceIndex.load(path, device="cpu"), queries, SearchParameters(**EXACT))
    dev = load_grid_only(path, device="cpu", **kw)
    host = load_grid_only(path, refine="host", device="cpu", **kw)
    off = load_grid_only(path, refine=False, device="cpu", **kw)
    assert dev.refine_side == "device" and dev.refine_host is None
    assert dev.codes.shape[0] == dev.num_embeddings
    assert dev.residuals.shape == (dev.num_embeddings, dev.dim * dev.nbits // 8)
    assert host.refine_side == "host" and host.codes.shape[0] == 0
    assert off.refine_side == "none"
    refined = {}
    for name, index in (("device", dev), ("host", host)):
        refined[name] = search_batch(index, queries, SearchParameters(**EXACT))
        for a, b in zip(oracle, refined[name]):
            assert a.passage_ids == b.passage_ids, (name, a, b)
            np.testing.assert_allclose(a.scores, b.scores, rtol=1e-5, atol=1e-5)
    for a, b in zip(refined["device"], refined["host"]):
        assert a.passage_ids == b.passage_ids
        np.testing.assert_allclose(a.scores, b.scores, rtol=1e-6, atol=1e-6)
    # Deeper than 128 candidates: the union rerank at result() time.
    deep = search_batch(dev, queries, SearchParameters(refine_depth=150, **EXACT))
    for a, b in zip(oracle, deep):
        assert a.passage_ids == b.passage_ids
        np.testing.assert_allclose(a.scores, b.scores, rtol=1e-5, atol=1e-5)
    # refine_depth=-1 and refine=False both serve the int8 scores.
    raw = search_batch(dev, queries, SearchParameters(refine_depth=-1, **EXACT))
    raw_off = search_batch(off, queries, SearchParameters(**EXACT))
    for a, b in zip(raw, raw_off):
        assert a.passage_ids == b.passage_ids
        np.testing.assert_allclose(a.scores, b.scores, rtol=1e-6, atol=1e-6)
    assert any(
        not np.allclose(a.scores, b.scores, rtol=1e-5, atol=1e-5)
        for a, b in zip(oracle, raw)
    )


def test_host_refine_gather_equals_disk_rows(built):
    path, _, _, _, _ = built
    full = DeviceIndex.load(path, device="cpu")
    host = load_grid_only(path, refine="host", device="cpu")
    ids = np.asarray([0, full.num_documents - 1, 3, 150, 47], np.int64)
    codes, res, lens = host.refine_host.gather(ids)
    doclens = full.doclens.numpy()
    assert lens.tolist() == [int(doclens[i]) for i in ids]
    offs = np.concatenate([[0], np.cumsum(doclens)])
    pos = np.concatenate([np.arange(offs[i], offs[i] + doclens[i]) for i in ids])
    np.testing.assert_array_equal(codes, full.codes.numpy()[pos])
    np.testing.assert_array_equal(res, full.residuals.numpy()[pos])


def test_grid_only_preflight_and_staged_mode(built, monkeypatch):
    path, _, queries, _, _ = built
    monkeypatch.setattr(container, "_device_hbm_bytes", lambda device: 1 << 20)
    for buckets in (1, 4):
        with pytest.raises(StorageError, match="grid-only load needs"):
            load_grid_only(path, dtype="int8", buckets=buckets, device="cpu")
    monkeypatch.setattr(container, "_device_hbm_bytes", lambda device: 1 << 40)
    go = load_grid_only(path, dtype="bf16", device="cpu")
    assert go.grid_only and go.refine_side == "none"  # bf16 never refines
    with pytest.raises(SearchError):
        search_batch(go, queries, SearchParameters(top_k=5, mode="staged"))
    with pytest.raises(StorageError):
        load_grid_only(path, dtype="fp8", device="cpu")
