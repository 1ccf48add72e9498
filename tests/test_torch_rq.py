"""The port's RQ (residual-quantized) centroid structure against the JAX
package's, on the CPU.

1. The reference battery: `tests/test_rq.py` and `tests/test_rq_index.py` run
   against `nextplaid_tpu_torch` through `port_battery`. Edits: test_rq.py's
   `jnp.asarray` inputs become CPU tensors (`torch.as_tensor`); the entry
   points of test_rq_index.py get device="cpu" (`create_index`,
   `DeviceIndex.load`, `update_or_create`). Every test of both files runs;
   none is adapted or left out.
2. `ops/rq.py` against `nextplaid_tpu.ops.rq` on the same seeded inputs:
   `pair_scores_topk` (same pair sets, values within 1e-5),
   `assign_codes_rq` and `_assign_chunked` (equal codes but at ties within
   1e-6), `train_rq` with the JAX Lloyd step carried across (codebooks within
   1e-5).
3. Builds: `create_index(centroid_structure="rq")`, in memory and streamed,
   with the JAX codebook carried across, write directories byte-identical to
   the JAX package's (rq_coarse.npy and rq_fine.npy included); an
   interrupted and resumed RQ streamed build equals an uninterrupted one.
4. Search on a JAX-built RQ index (400 docs of 6-13 tokens, d 32, nbits 4;
   64 queries of 8 tokens): stages 1-2 equal the JAX package's, and the
   ranked top-10 equals the JAX package's at every parameter set of
   `PROBE_CASES`, score-sorted with a tie tolerance; at the prune cut a doc
   may be in one package's list only when its approximate score ties the
   cut's exactly (the two packages break such ties differently: see
   `test_prune_cut_ties_keep_lower_ids`). The first case is the regression
   test of the port's former flat stages 1-2 on RQ indexes.
5. Updates: buffer mode keeps the sidecars, assigns through the codebook and
   writes the JAX package's bytes; expansion drops the sidecars with the JAX
   package's warning; a start-from-scratch rebuild keeps the structure; the
   merge cache (on and off) leaves the RQ fields to the sidecars.
"""

import dataclasses
import logging
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nextplaid_tpu.index as J
from nextplaid_tpu.index import search as JS
from nextplaid_tpu.index import update as JU
from nextplaid_tpu.ops import kmeans as jax_kmeans
from nextplaid_tpu.ops import rq as jax_rq
from nextplaid_tpu_torch.index import (
    DeviceIndex,
    IndexConfig,
    SearchParameters,
    create_index,
    create_index_streamed,
    search_batch,
)
from nextplaid_tpu_torch.index import search as TS
from nextplaid_tpu_torch.index import update as TU
from nextplaid_tpu_torch.index.build import DeviceChunk
from nextplaid_tpu_torch.index.container import load_host_arrays
from nextplaid_tpu_torch.ops import kmeans as torch_kmeans
from nextplaid_tpu_torch.ops import rq
from nextplaid_tpu_torch.storage.npy import IndexLayout
from nextplaid_tpu_torch.utils.errors import StorageError
from tests.staged_compare import _assert_same_topk_but_cut_ties
from tests.test_torch_api import port_battery
from tests.test_torch_build import _assert_same_files, carried_lloyd  # noqa: F401 (fixture)
from tests.test_torch_staged import _cells_scores
from tests.test_torch_update import _assert_same_dir, carried_kmeans  # noqa: F401 (fixture)

CPU = "cpu"
DIM = 32
TIE = 1e-6

# ---------------------------------------------------------------------------
# 1. The reference battery
# ---------------------------------------------------------------------------

_rq_ref = port_battery(
    "test_rq",
    ("import jax.numpy as jnp",
     "import torch\n\n\nclass jnp:  # the port's functions take tensors\n"
     "    asarray = staticmethod(lambda x: torch.as_tensor(np.asarray(x)))"),
)
_rq_index_ref = port_battery(
    "test_rq_index",
    ('IndexConfig(nbits=4, seed=42, centroid_structure="rq")\n    )',
     'IndexConfig(nbits=4, seed=42, centroid_structure="rq"), device="cpu"\n    )'),
    ("DeviceIndex.load(path)", 'DeviceIndex.load(path, device="cpu")'),
    ("DeviceIndex.load(upd)", 'DeviceIndex.load(upd, device="cpu")'),
    ("update_or_create(new_docs, upd, UpdateConfig())",
     'update_or_create(new_docs, upd, UpdateConfig(), device="cpu")'),
    ("new_docs, upd, UpdateConfig(buffer_size=0)\n        )",
     'new_docs, upd, UpdateConfig(buffer_size=0), device="cpu"\n        )'),
)
RQ_TESTS = tuple(n for n in dir(_rq_ref) if n.startswith("test_"))
RQ_INDEX_TESTS = tuple(n for n in dir(_rq_index_ref) if n.startswith("test_"))
codebook = _rq_ref.codebook
built = _rq_index_ref.built
for _name in RQ_TESTS:
    globals()[_name] = getattr(_rq_ref, _name)
for _name in RQ_INDEX_TESTS:
    globals()[_name] = getattr(_rq_index_ref, _name)


def test_battery_runs_every_reference_test():
    assert len(RQ_TESTS) == 7 and len(RQ_INDEX_TESTS) == 4


# ---------------------------------------------------------------------------
# 2. ops/rq.py against the JAX package
# ---------------------------------------------------------------------------


def _unit(x):
    return (x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)).astype(np.float32)


def _book(seed, c=32, f=16, d=16, degenerate=True):
    rng = np.random.default_rng(seed)
    coarse = _unit(rng.standard_normal((c, d)))
    fine = (0.3 * rng.standard_normal((f, d))).astype(np.float32)
    if degenerate:  # pairs (0, 0) and (3, 1) cancel: inv_norm 0
        fine[0], fine[1] = -coarse[0], -coarse[3]
    return rq.RQCodebook(coarse=coarse, fine=fine)


def test_codebook_matches_jax():
    book = _book(0)
    ref = jax_rq.RQCodebook(coarse=book.coarse, fine=book.fine)
    np.testing.assert_array_equal(book.flat_centroids(), ref.flat_centroids())
    np.testing.assert_array_equal(book.inv_norms(), ref.inv_norms())
    assert book.inv_norms()[0, 0] == 0 and book.inv_norms()[3, 1] == 0
    for k in (1, 2, 1024, 65536, 131072):
        assert rq.rq_split(k) == jax_rq.rq_split(k)
    assert (rq.MIN_PAIR_NORM, rq.RQ_MIN_K, rq.RQ_MAX_TRAIN_TOKENS) == (
        jax_rq.MIN_PAIR_NORM, jax_rq.RQ_MIN_K, jax_rq.RQ_MAX_TRAIN_TOKENS)


@pytest.mark.parametrize("k,a,b", [(4, 32, 16), (8, 10, 6), (16, 4, 4), (1, 3, 2)])
def test_pair_scores_topk_matches_jax(k, a, b):
    book = _book(1)
    rng = np.random.default_rng(2)
    q = _unit(rng.standard_normal((5, 7, 16)))
    # Token 0 of query 0 points at the degenerate pair (0, 0).
    q[0, 0] = book.coarse[0]
    xc, xf, inv = q @ book.coarse.T, q @ book.fine.T, book.inv_norms()
    want_v, want_c = jax_rq.pair_scores_topk(
        jnp.asarray(xc), jnp.asarray(xf), jnp.asarray(inv), k=k, a=a, b=b)
    got_v, got_c = rq.pair_scores_topk(
        torch.from_numpy(xc), torch.from_numpy(xf), torch.from_numpy(inv), k=k, a=a, b=b)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0, atol=1e-5)
    got_c, want_c = got_c.numpy(), np.asarray(want_c)
    for row_g, row_w, vals in zip(got_c.reshape(-1, k), want_c.reshape(-1, k),
                                  got_v.numpy().reshape(-1, k)):
        finite = np.isfinite(vals)
        assert set(row_g[finite]) == set(row_w[finite])
    # The degenerate pair never comes back with a finite score.
    assert not np.any((got_c == 0) & np.isfinite(got_v.numpy()))


def test_pair_scores_topk_ties_go_to_lower_index():
    """Equal pair scores come back in index order, as lax.top_k's do."""
    coarse = np.eye(4, dtype=np.float32)
    fine = np.zeros((4, 4), np.float32) + 0.5
    inv = np.ones((4, 4), np.float32)
    xc = np.zeros((1, 4), np.float32)
    xf = np.zeros((1, 4), np.float32)
    v, c = rq.pair_scores_topk(torch.from_numpy(xc), torch.from_numpy(xf),
                               torch.from_numpy(inv), k=5, a=4, b=4)
    jv, jc = jax_rq.pair_scores_topk(jnp.asarray(xc), jnp.asarray(xf), jnp.asarray(inv),
                                     k=5, a=4, b=4)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(c.numpy()[0], [0, 1, 2, 3, 4])
    del coarse, fine, v, jv


def _assert_same_codes_but_ties(got, want, scores):
    """Codes equal, except where the two codes' scores tie within TIE."""
    for i in np.nonzero(got != want)[0]:
        assert abs(scores[i, got[i]] - scores[i, want[i]]) <= TIE, (i, got[i], want[i])


@pytest.mark.parametrize("chunk,kblk", [(8192, 8192), (256, 100), (300, 512), (50, 7)])
def test_assign_codes_rq_matches_jax(chunk, kblk):
    book = _book(3)
    tokens = _unit(np.random.default_rng(4).standard_normal((1000, 16)))
    args = (book.coarse, book.fine, book.inv_norms())
    want = np.asarray(jax_rq.assign_codes_rq(
        jnp.asarray(tokens), *map(jnp.asarray, args), chunk=chunk, kblk=kblk))
    got = rq.assign_codes_rq(torch.from_numpy(tokens), *map(torch.from_numpy, args),
                             chunk=chunk, kblk=kblk)
    assert got.dtype == torch.int32
    scores = tokens @ book.flat_centroids().T
    scores[:, book.inv_norms().reshape(-1) == 0] = -np.inf
    _assert_same_codes_but_ties(got.numpy(), want, scores)
    # The blocked running max gives one argmax over K.
    np.testing.assert_array_equal(got.numpy(), np.argmax(scores, axis=1))


def test_blocked_argmax_takes_the_first_maximum():
    """Exact ties across K blocks (and in the clamped tail block) resolve to
    the lowest index, as a single argmax does."""
    table = torch.zeros((10, 2))
    table[[2, 5, 9], 0] = 1.0  # three equal maxima, in blocks 0, 1 and the tail
    rows = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    bias = torch.zeros(10)
    for kblk in (1, 3, 4, 10, 64):
        got = rq._blocked_argmax(rows, table, bias, kblk)
        assert got.tolist() == [2, 0]
    bias[2] = float("-inf")
    assert rq._blocked_argmax(rows, table, bias, 4).tolist() == [5, 0]


@pytest.mark.parametrize("chunk", [64, 1000, 4096])
def test_assign_chunked_matches_jax(chunk):
    rng = np.random.default_rng(5)
    data = rng.standard_normal((1000, 16)).astype(np.float32)
    cents = rng.standard_normal((40, 16)).astype(np.float32)
    want = np.asarray(jax_rq._assign_chunked(jnp.asarray(data), jnp.asarray(cents), chunk))
    got = rq._assign_chunked(torch.from_numpy(data), torch.from_numpy(cents), chunk).numpy()
    _assert_same_codes_but_ties(got, want, data @ cents.T)


def _training_data(seed=6, n=6000, d=24):
    rng = np.random.default_rng(seed)
    centers = _unit(rng.standard_normal((64, d)))
    return _unit(centers[rng.integers(0, 64, n)] + 0.15 * rng.standard_normal((n, d)))


@pytest.mark.parametrize("refine_iters", [0, 4])
def test_train_rq_matches_jax(carried_lloyd, refine_iters):
    data = _training_data()
    want = jax_rq.train_rq(jnp.asarray(data), num_coarse=16, num_fine=8, seed=0,
                           refine_iters=refine_iters)
    got = rq.train_rq(torch.from_numpy(data), num_coarse=16, num_fine=8, seed=0,
                      refine_iters=refine_iters)
    np.testing.assert_allclose(got.coarse, want.coarse, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.fine, want.fine, rtol=1e-5, atol=1e-5)


def test_refine_step_matches_jax():
    data = _training_data(seed=7, n=3000)
    book = _book(8, c=16, f=8, d=24, degenerate=False)
    want = jax_rq._refine_rq_step(jnp.asarray(data), jnp.asarray(book.coarse),
                                  jnp.asarray(book.fine), chunk=512, kblk=50)
    got = rq._refine_rq_step(torch.from_numpy(data), torch.from_numpy(book.coarse),
                             torch.from_numpy(book.fine), chunk=512, kblk=50)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_train_rq_too_small_sample_raises():
    with pytest.raises(ValueError, match="too small"):
        rq.train_rq(torch.zeros((4, 8)), num_coarse=8, num_fine=2)


# ---------------------------------------------------------------------------
# 3. Builds
# ---------------------------------------------------------------------------


def _corpus(seed=0, n_docs=120, lo=6, hi=14, n_topics=40):
    rng = np.random.default_rng(seed)
    topics = _unit(rng.standard_normal((n_topics, DIM)))
    docs = [_unit(topics[rng.integers(0, n_topics, n)] + 0.25 * rng.standard_normal((n, DIM)))
            for n in rng.integers(lo, hi, n_docs)]
    return docs, topics


def _to_port_book(book):
    return rq.RQCodebook(coarse=np.asarray(book.coarse), fine=np.asarray(book.fine))


@pytest.fixture
def carried_rq(monkeypatch):
    """The port's RQ training returns the JAX package's codebook for the same
    inputs (in memory: `compute_rq_kmeans`; streamed: `train_rq`)."""

    def compute(docs, config=None, flat_device=None, device=None):
        config = config or torch_kmeans.KMeansConfig()
        return _to_port_book(jax_rq.compute_rq_kmeans(
            docs,
            jax_kmeans.KMeansConfig(
                num_partitions=config.num_partitions, kmeans_niters=config.kmeans_niters,
                max_points_per_centroid=config.max_points_per_centroid,
                n_samples_kmeans=config.n_samples_kmeans, seed=config.seed),
            flat_device=None if flat_device is None else jnp.asarray(flat_device.numpy()),
        ))

    def train(sample, num_coarse, num_fine, iters=4, refine_iters=4, seed=42):
        return _to_port_book(jax_rq.train_rq(jnp.asarray(sample.numpy()), num_coarse, num_fine,
                                             iters=iters, refine_iters=refine_iters, seed=seed))

    monkeypatch.setattr(rq, "compute_rq_kmeans", compute)
    monkeypatch.setattr(rq, "train_rq", train)


RQ_CFG = dict(nbits=4, seed=42, centroid_structure="rq")


@pytest.mark.parametrize("n_docs", [120, 1100], ids=["raw_embeddings", "no_raw_embeddings"])
def test_create_index_rq_matches_jax(carried_rq, tmp_path, n_docs):
    docs, _ = _corpus(n_docs=n_docs)
    ours, ref = str(tmp_path / "torch"), str(tmp_path / "jax")
    meta = create_index(docs, ours, IndexConfig(**RQ_CFG), device=CPU)
    J.create_index(docs, ref, J.IndexConfig(**RQ_CFG))
    layout = IndexLayout(ours)
    assert layout.rq_coarse.exists() and layout.rq_fine.exists()
    c, f = np.load(layout.rq_coarse).shape[0], np.load(layout.rq_fine).shape[0]
    assert c * f == meta.num_partitions
    _assert_same_files(ours, ref)


def test_create_index_rq_own_training(tmp_path):
    """The port's own RQ training: the codebook within 1e-4 of the JAX
    package's, every code a valid (non-degenerate) cell."""
    docs, _ = _corpus(seed=1)
    ours, ref = str(tmp_path / "torch"), str(tmp_path / "jax")
    create_index(docs, ours, IndexConfig(**RQ_CFG), device=CPU)
    J.create_index(docs, ref, J.IndexConfig(**RQ_CFG))
    for name in ("rq_coarse.npy", "rq_fine.npy", "centroids.npy"):
        np.testing.assert_allclose(np.load(os.path.join(ours, name)),
                                   np.load(os.path.join(ref, name)), rtol=1e-4, atol=1e-4)
    index = DeviceIndex.load(ours, device=CPU)
    inv = index.rq_inv_norms.reshape(-1)
    assert (inv[index.codes[: index.num_embeddings].long()] > 0).all()


class _Interrupted(RuntimeError):
    pass


def _chunks(docs, to_tensor, make, chunk_docs=20, stop=None):
    for i, s in enumerate(range(0, len(docs), chunk_docs)):
        if i == stop:
            raise _Interrupted(f"chunk {i}")
        batch = docs[s : s + chunk_docs]
        yield make(to_tensor(np.concatenate(batch)),
                   np.asarray([d.shape[0] for d in batch], np.int64))


def _torch_streamed(docs, path, stop=None, resume=False, cfg=RQ_CFG):
    flat = np.concatenate(docs)
    return create_index_streamed(
        _chunks(docs, torch.from_numpy, lambda t, d: DeviceChunk(tokens=t, doclens=d), stop=stop),
        path, IndexConfig(**cfg), sample_tokens=torch.from_numpy(flat),
        est_total_tokens=flat.shape[0], resume=resume, device=CPU)


def _jax_streamed(docs, path, stop=None, resume=False, cfg=RQ_CFG):
    flat = np.concatenate(docs)
    return J.create_index_streamed(
        _chunks(docs, jnp.asarray, lambda t, d: J.build.DeviceChunk(tokens=t, doclens=d),
                stop=stop),
        path, J.IndexConfig(**cfg), sample_tokens=jnp.asarray(flat),
        est_total_tokens=flat.shape[0], resume=resume)


def test_streamed_rq_matches_jax(carried_rq, tmp_path):
    docs, _ = _corpus(seed=2)
    ours, ref = str(tmp_path / "torch"), str(tmp_path / "jax")
    _torch_streamed(docs, ours)
    _jax_streamed(docs, ref)
    assert IndexLayout(ours).rq_fine.exists()
    _assert_same_files(ours, ref)


def test_streamed_rq_resumed_matches_uninterrupted(tmp_path):
    docs, _ = _corpus(seed=3)
    path, fresh = str(tmp_path / "idx"), str(tmp_path / "fresh")
    with pytest.raises(_Interrupted):
        _torch_streamed(docs, path, stop=3)
    layout = IndexLayout(path)
    assert layout.rq_coarse.exists() and not layout.metadata.exists()
    mtimes = {n: os.stat(os.path.join(path, n)).st_mtime_ns for n in os.listdir(path)
              if n.startswith(("0.", "1.", "2."))}
    _torch_streamed(docs, path, resume=True)
    assert {n: os.stat(os.path.join(path, n)).st_mtime_ns for n in mtimes} == mtimes
    _torch_streamed(docs, fresh)
    _assert_same_files(path, fresh)


def test_streamed_rq_resumed_matches_jax(carried_rq, tmp_path):
    docs, _ = _corpus(seed=4)
    ours, ref = str(tmp_path / "torch"), str(tmp_path / "jax")
    for build, path in ((_torch_streamed, ours), (_jax_streamed, ref)):
        with pytest.raises(_Interrupted):
            build(docs, path, stop=2)
        build(docs, path, resume=True)
    _assert_same_files(ours, ref)


def test_streamed_flat_rewrite_drops_sidecars(tmp_path):
    docs, _ = _corpus(seed=5)
    path = str(tmp_path / "idx")
    _torch_streamed(docs, path)
    _torch_streamed(docs, path, cfg=dict(RQ_CFG, centroid_structure="auto"))
    assert not IndexLayout(path).rq_coarse.exists()
    assert not IndexLayout(path).rq_fine.exists()
    assert DeviceIndex.load(path, device=CPU).rq_coarse is None


# ---------------------------------------------------------------------------
# 4. Search on a JAX-built RQ index
# ---------------------------------------------------------------------------

PROBE_CASES = {
    "nprobe1_keep16": dict(n_ivf_probe=1, prune_keep=16),
    "nprobe4_keep16": dict(n_ivf_probe=4, prune_keep=16),
    "nprobe1_keep32_threshold0.6": dict(n_ivf_probe=1, prune_keep=32,
                                         centroid_score_threshold=0.6),
    "defaults": dict(),
    "cells_nprobe2_keep8": dict(approx_score="cells", n_ivf_probe=2, prune_keep=8),
}
STAGED = dict(top_k=10, mode="staged", stage1_precision="highest")


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    """400 docs of 6-13 tokens at d 32 built by the JAX package with the RQ
    structure (K 512 = 32 x 16); 64 queries of 8 tokens."""
    docs, topics = _corpus(seed=0, n_docs=400)
    rng = np.random.default_rng(1)
    queries = [_unit(topics[rng.integers(0, len(topics), 8)] + 0.2 * rng.standard_normal((8, DIM)))
               for _ in range(64)]
    path = str(tmp_path_factory.mktemp("rq_probe") / "idx")
    J.create_index(docs, path, J.IndexConfig(**RQ_CFG))
    return dict(path=path, queries=queries, ref=J.DeviceIndex.load(path),
                ours=DeviceIndex.load(path, device=CPU))


def test_probe_index_loads_rq_fields(probe):
    ref, ours = probe["ref"], probe["ours"]
    for name in ("rq_coarse", "rq_fine", "rq_inv_norms"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)))
    assert ours.rq_coarse.shape[0] * ours.rq_fine.shape[0] == ours.num_centroids == 512


def _stage12_rq(probe, params):
    ref, ours, queries = probe["ref"], probe["ours"], probe["queries"]
    q_arr, q_mask = TS._pad_queries(queries, DIM)
    k = ours.num_centroids
    jsh = JS.PipelineShapes.derive(ref, J.SearchParameters(**params), len(queries), q_arr.shape[1])
    tsh = TS.PipelineShapes.derive(ours, SearchParameters(**params), len(queries), q_arr.shape[1])
    jc, jw = JS._dedup_cells(*JS._select_cells_rq(jnp.asarray(q_arr), jnp.asarray(q_mask), ref, jsh),
                             k, threshold=jsh.threshold)
    tc, tw = TS._dedup_cells(*TS._select_cells_rq(torch.from_numpy(q_arr),
                                                  torch.from_numpy(q_mask), ours, tsh),
                             k, threshold=tsh.threshold)
    return tsh, tc.numpy(), tw.numpy(), np.asarray(jc), np.asarray(jw)


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_rq_stage12_matches_jax(probe, case):
    _, tc, tw, jc, jw = _stage12_rq(probe, dict(STAGED, **PROBE_CASES[case]))
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.sort(tc, axis=1), np.sort(jc, axis=1))
    for q, i in zip(*np.nonzero(tc != jc)):  # equal weights may swap places
        (j,) = np.nonzero(jc[q] == tc[q, i])[0]
        assert abs(tw[q, i] - tw[q, j]) <= 1e-5


def _cut_ties(probe, params):
    """The docs whose approximate score ties a prune cut's (the pool-th or
    the keep-th best of a query) within TIE, where more docs tie than the cut keeps. Scores
    by plain numpy from the port's cells. Every query is scored against the
    batch's union of survivors (candidate_scope "batch"), so a tie at any
    query's cut can change every query's list: the set is the batch's, one
    copy a query."""
    shapes, cells, weights, _, _ = _stage12_rq(probe, params)
    approx = _cells_scores({"arrays": probe["ours"]}, cells, weights, shapes.posting_budget)
    tied = set()
    for row in approx:
        live = np.sort(row[np.isfinite(row)])[::-1]
        # Two cuts: the pool, then the keep (the RQ fallback of "codes"
        # takes the pool's first `keep` by the same scores).
        for n in {shapes.prune_pool, shapes.prune_keep}:
            if len(live) > n and live[n] >= live[n - 1] - TIE:
                tied |= set(np.nonzero(np.abs(row - live[n - 1]) <= TIE)[0].tolist())
    return [tied] * approx.shape[0]


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_rq_staged_search_matches_jax(probe, case):
    """The fault's regression test at "nprobe1_keep16": with flat stages 1-2
    over centroids.npy on this RQ index, the port's lists differ from the
    JAX package's in 29 of these 64 queries, 10 of them beyond the cut ties
    this comparison allows."""
    params = dict(STAGED, **PROBE_CASES[case])
    ours = search_batch(probe["ours"], probe["queries"], SearchParameters(**params))
    ref = J.search_batch(probe["ref"], probe["queries"], J.SearchParameters(**params))
    _assert_same_topk_but_cut_ties(ours, ref, _cut_ties(probe, params))


def test_rq_codes_scoring_falls_back_to_cells(probe):
    """Without the [Q, Tq, K] table, approx_score="codes" ranks the pool by
    the cell weights, as "cells" with the same pool does."""
    base = dict(STAGED, n_ivf_probe=2, prune_keep=8)
    codes = search_batch(probe["ours"], probe["queries"],
                         SearchParameters(approx_score="codes", **base))
    ref = J.search_batch(probe["ref"], probe["queries"],
                         J.SearchParameters(approx_score="codes", **base))
    _assert_same_topk_but_cut_ties(codes, ref, _cut_ties(probe, dict(base, approx_score="codes")))


def test_flat_control_is_the_old_path(probe):
    """With its rq_* fields set to None the same index searches its flat
    table, as the JAX package does with the same fields dropped."""
    params = dict(STAGED, n_ivf_probe=4, prune_keep=64)
    flat_t = dataclasses.replace(probe["ours"], rq_coarse=None, rq_fine=None, rq_inv_norms=None)
    flat_j = dataclasses.replace(probe["ref"], rq_coarse=None, rq_fine=None, rq_inv_norms=None)
    ours = search_batch(flat_t, probe["queries"], SearchParameters(**params))
    ref = J.search_batch(flat_j, probe["queries"], J.SearchParameters(**params))
    rq_ours = search_batch(probe["ours"], probe["queries"], SearchParameters(**params))
    assert [r.passage_ids[0] for r in ours] == [r.passage_ids[0] for r in ref]
    assert ([r.passage_ids for r in ours] != [r.passage_ids for r in rq_ours])


def test_prune_cut_ties_keep_lower_ids():
    """Forty docs share one probed cell, so all tie on the approximate score
    at a cut of 16. The port keeps the 16 lowest ids; the JAX package's
    survivors follow the rounding of its running f32 cumsum; both sets'
    approximate scores agree within 1e-6."""
    n, k, d, nbits = 40, 4, 8, 4
    rng = np.random.default_rng(0)
    arrays = dict(
        centroids=_unit(rng.standard_normal((k, d))),
        codes=np.zeros(n, np.int32),
        residuals=np.zeros((n, d * nbits // 8), np.uint8),
        doclens=np.ones(n, np.int32),
        ivf_lengths=np.asarray([n, 0, 0, 0], np.int32),
        ivf_doc_ids=np.arange(n, dtype=np.int64),
        bucket_cutoffs=np.linspace(-0.1, 0.1, 15).astype(np.float32),
        bucket_weights=np.linspace(-0.1, 0.1, 16).astype(np.float32),
        avg_residual=np.zeros(d, np.float32),
        nbits=nbits,
    )
    ours = DeviceIndex.from_host(**arrays, device=CPU)
    ref = J.DeviceIndex.from_host(**arrays)
    params = dict(STAGED, approx_score="cells", n_ivf_probe=1, prune_keep=16)
    tsh = TS.PipelineShapes.derive(ours, SearchParameters(**params), 1, 32)
    jsh = JS.PipelineShapes.derive(ref, J.SearchParameters(**params), 1, 32)
    w = np.float32(0.6256831)
    cells = np.full((1, 32), k, np.int32)
    cells[0, 0] = 0
    weights = np.zeros((1, 32), np.float32)
    weights[0, 0] = w
    tu, _, _ = TS._prune_candidates(ours, torch.from_numpy(cells).long(),
                                    torch.from_numpy(weights), tsh)
    ju, _, _ = JS._prune_candidates(ref, jnp.asarray(cells), jnp.asarray(weights), jsh)
    keep_t = sorted(x for x in tu.tolist() if x < n)
    keep_j = sorted(int(x) for x in np.asarray(ju) if x < n)
    assert keep_t == list(range(16)) and len(keep_j) == 16
    approx = _cells_scores({"arrays": ours}, cells, weights, tsh.posting_budget)[0]
    np.testing.assert_allclose(approx[keep_t], approx[keep_j], rtol=0, atol=TIE)
    np.testing.assert_allclose(approx[keep_j], w, rtol=0, atol=TIE)


# ---------------------------------------------------------------------------
# 5. Updates and loads
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rq_base(tmp_path_factory):
    docs, topics = _corpus(seed=7, n_docs=200)
    path = str(tmp_path_factory.mktemp("rq_base") / "idx")
    J.create_index(docs, path, J.IndexConfig(**RQ_CFG))
    return path, topics


@pytest.fixture
def rq_pair(rq_base, tmp_path):
    a, b = str(tmp_path / "jax"), str(tmp_path / "torch")
    shutil.copytree(rq_base[0], a)
    shutil.copytree(rq_base[0], b)
    return a, b


def _near(topics, n, seed, far=False):
    rng = np.random.default_rng(seed)
    if far:
        return [_unit(rng.standard_normal((8, DIM))) for _ in range(n)]
    return [_unit(topics[rng.integers(0, len(topics), 7)] + 0.1 * rng.standard_normal((7, DIM)))
            for _ in range(n)]


def test_rq_buffer_update_byte_identical(rq_pair, rq_base):
    a, b = rq_pair
    new = _near(rq_base[1], 5, seed=8)
    ia, ib = {}, {}
    ids_a = JU.update(new, a, JU.UpdateConfig(start_from_scratch=0), info_out=ia)
    ids_b = TU.update(new, b, TU.UpdateConfig(start_from_scratch=0), info_out=ib, device=CPU)
    assert ids_a == ids_b and ib["mode"] == "buffer"
    for x, y in zip(ia["encoded"], ib["encoded"]):
        np.testing.assert_array_equal(x, y)
    assert IndexLayout(b).rq_coarse.exists() and IndexLayout(b).rq_fine.exists()
    _assert_same_dir(a, b)
    # Codes came through the codebook: the exact assignment of the new
    # tokens, never a degenerate pair.
    index = DeviceIndex.load(b, device=CPU)
    codes = rq.assign_codes_rq(torch.from_numpy(np.concatenate(new)), index.rq_coarse,
                               index.rq_fine, index.rq_inv_norms)
    np.testing.assert_array_equal(ib["encoded"][0], codes.numpy())


def test_rq_expansion_drops_sidecars(rq_pair, rq_base, carried_kmeans, caplog):
    a, b = rq_pair
    new = _near(rq_base[1], 12, seed=9, far=True)
    JU.update(new, a, JU.UpdateConfig(start_from_scratch=0, buffer_size=0))
    with caplog.at_level(logging.WARNING, logger="nextplaid_tpu_torch.index.update"):
        info = {}
        TU.update(new, b, TU.UpdateConfig(start_from_scratch=0, buffer_size=0),
                  info_out=info, device=CPU)
    assert info["mode"] == "expand"
    assert any("RQ index" in r.getMessage() and r.name == "nextplaid_tpu_torch.index.update"
               for r in caplog.records)
    assert not IndexLayout(b).rq_coarse.exists() and not IndexLayout(b).rq_fine.exists()
    _assert_same_dir(a, b)


def test_rq_scratch_rebuild_keeps_structure(rq_pair, rq_base, carried_rq):
    a, b = rq_pair
    new = _near(rq_base[1], 4, seed=10)
    JU.update(new, a, JU.UpdateConfig())
    info = {}
    TU.update(new, b, TU.UpdateConfig(), info_out=info, device=CPU)
    assert info["mode"] == "scratch"
    assert IndexLayout(b).rq_coarse.exists() and IndexLayout(b).rq_fine.exists()
    _assert_same_dir(a, b)


@pytest.mark.parametrize("flag", ["0", "1"], ids=["cache_off", "cache_on"])
def test_load_keeps_rq_fields_through_the_merge_cache(rq_pair, monkeypatch, flag):
    _, path = rq_pair
    monkeypatch.setenv("NEXT_PLAID_MERGE_CACHE", flag)
    want = J.DeviceIndex.load(path)
    for _ in range(2):  # with the cache on: a miss that stores it, then a hit
        h = load_host_arrays(path)
        np.testing.assert_array_equal(h["rq_coarse"], np.load(IndexLayout(path).rq_coarse))
        index = DeviceIndex.load(path, device=CPU)
        np.testing.assert_array_equal(index.rq_inv_norms.numpy(), np.asarray(want.rq_inv_norms))
    assert os.path.exists(os.path.join(path, "merged", "manifest.json")) == (flag == "1")
    # Sidecars of another build generation (C*F != K) are dropped, on a hit
    # too: the flat table is authoritative.
    np.save(IndexLayout(path).rq_fine, np.zeros((3, DIM), np.float32))
    h = load_host_arrays(path)
    assert h["rq_coarse"] is None and h["rq_fine"] is None
    assert DeviceIndex.load(path, device=CPU).rq_inv_norms is None


def test_resume_refuses_sidecars_of_another_table(tmp_path):
    docs, _ = _corpus(seed=11)
    path = str(tmp_path / "idx")
    with pytest.raises(_Interrupted):
        _torch_streamed(docs, path, stop=1)
    np.save(IndexLayout(path).rq_fine, np.zeros((3, DIM), np.float32))
    with pytest.raises(StorageError, match="RQ sidecars"):
        _torch_streamed(docs, path, resume=True)
