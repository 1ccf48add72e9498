"""The port's doc-range sharding (`nextplaid_tpu_torch.parallel`) against the
JAX package's, on the CPU: eight "cpu" shards stand for the JAX tests'
eight virtual CPU devices (tests/conftest.py).

1. The reference battery: every test of `tests/test_sharded.py` runs
   against the port, loaded by `port_battery` with these source edits:
   - `make_mesh()` -> eight CPU shards, `make_mesh(devices=["cpu"] * 8)`;
   - `create_index`, `DeviceIndex.load` and `update_or_create` given
     device="cpu" (the port's entry points take "cuda" otherwise);
   - `test_lloyd_sharded_matches_single`: the `jnp` Lloyd reference is the
     port's `lloyd` on CPU tensors, and `lloyd_sharded` is given the CPU
     mesh;
   - `test_reshard_latency_bound`: its unused `import jax.numpy` goes;
   - `sg.grid.shape[1]` / `sg.grid.shape[2]` (the JAX package's stacked
     [S, rows, Td, d] bf16 grid) -> `sg.rows` / `sg.grid_td`: the port holds
     one grid a shard.
2. Parity with the JAX package's sharded functions on one index and the JAX
   8-device mesh: shard layouts array for array; exact and staged
   `search_batch_sharded` top-10 (prune-cut ties allowed, as in
   tests/test_torch_rq.py); `search_batch_sharded_grid` scores within RTOL,
   ATOL = 1e-5, 1e-4 over the JAX shards carried across (`_carried`: the
   packages' bf16 grids agree within one bf16 rounding, which can move a
   score past ATOL, and their int8 grids within one step, so the grids
   themselves are held apart by `test_grid_shards_match_jax`);
   `lloyd_sharded` within 1e-4; both appends (arrays, boundaries,
   spills, the None cases) and `HostIndexData.load` field for field.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

import nextplaid_tpu.index as J
import nextplaid_tpu.parallel as JP
from nextplaid_tpu.index.update import UpdateConfig as JUpdateConfig
from nextplaid_tpu.index.update import update_or_create as j_update_or_create
from nextplaid_tpu_torch.index import DeviceIndex, SearchParameters
from nextplaid_tpu_torch.index import search as TS
from nextplaid_tpu_torch.index.container import int8_grid_from_interleaved
from nextplaid_tpu_torch.ops.maxsim_kernel import SMEM_LIMIT, plan_launch
from nextplaid_tpu_torch.parallel import (
    HostIndexData,
    ShardedGridIndex,
    ShardedIndex,
    lloyd_sharded,
    make_mesh,
    search_batch_sharded,
    search_batch_sharded_grid,
)
from nextplaid_tpu_torch.parallel import sharded as PS
from tests.test_index_e2e import make_corpus, make_queries
from tests.test_torch_api import port_battery
from tests.test_torch_grid_only import _assert_same_topk
from tests.test_torch_rq import TIE, _assert_same_topk_but_cut_ties
from tests.test_torch_staged import _cells_scores

RTOL, ATOL = 1e-5, 1e-4
CPU8 = ["cpu"] * 8

_ref = port_battery(
    "test_sharded",
    ("make_mesh()", "make_mesh(devices=['cpu'] * 8)"),
    ("create_index(docs, path, IndexConfig(nbits=4, seed=42))",
     "create_index(docs, path, IndexConfig(nbits=4, seed=42), device='cpu')"),
    ("DeviceIndex.load(path)", "DeviceIndex.load(path, device='cpu')"),
    ("        info_out=info,\n    )", "        info_out=info,\n        device='cpu',\n    )"),
    ("    import jax.numpy as jnp\n\n    single = np.asarray(lloyd(jnp.asarray(data), "
     "jnp.asarray(init), iters=3))",
     "    import torch\n\n    single = np.asarray(lloyd(torch.as_tensor(data), "
     "torch.as_tensor(init), iters=3))"),
    ("sharded = lloyd_sharded(data, init, iters=3)",
     "sharded = lloyd_sharded(data, init, iters=3, mesh=make_mesh(devices=['cpu'] * 8))"),
    ("    import time\n\n    import jax.numpy as jnp\n", "    import time\n"),
    ("rows = sg.grid.shape[1]", "rows = sg.rows"),
    ("td = sg.grid.shape[2]", "td = sg.grid_td"),
)
REFERENCE_TESTS = tuple(n for n in dir(_ref) if n.startswith("test_"))
for _name in REFERENCE_TESTS + ("built", "skewed", "grid_sharded", "staged_appendable"):
    globals()[_name] = getattr(_ref, _name)


def test_battery_runs_every_reference_test():
    assert len(REFERENCE_TESTS) == 21


# ---------------------------------------------------------------------------
# Parity with the JAX package's sharded functions
# ---------------------------------------------------------------------------

SHARDED_FIELDS = ("codes", "residuals", "doc_offsets", "doclens", "ivf_offsets", "ivf_doc_ids")
REPLICATED_FIELDS = ("centroids", "bucket_cutoffs", "bucket_weights", "avg_residual")
HOST_FIELDS = ("centroids", "codes", "residuals", "doclens", "doc_offsets",
               "bucket_cutoffs", "bucket_weights", "avg_residual")
STAGED_CASES = {
    "default": {},
    "keep16": {"n_full_scores": 64},
    "per_query": {"n_full_scores": 64, "candidate_scope": "per_query"},
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """400 docs of 3-12 tokens (d 32) built by the JAX package, and the two
    meshes: the JAX one over its 8 virtual CPU devices, the port's over 8
    CPU shards."""
    docs = make_corpus(num_docs=400, seed=29)
    path = str(tmp_path_factory.mktemp("shard_parity") / "corpus")
    J.create_index(docs, path, J.IndexConfig(nbits=4, seed=42))
    jmesh = JP.make_mesh()
    assert jmesh.devices.size == 8 and jax.default_backend() == "cpu"
    return docs, path, jmesh, make_mesh(devices=CPU8)


def _copy(path, tmp_path, name):
    dst = str(tmp_path / name)
    shutil.copytree(path, dst)
    return dst


def _encode_batch(docs, path, tmp_path):
    """A buffer-mode batch encoded against the index's centroids by the JAX
    package's update on a copy of `path` (both packages append it)."""
    info = {}
    j_update_or_create(
        docs, _copy(path, tmp_path, "encode_copy"),
        update_config=JUpdateConfig(start_from_scratch=0, buffer_size=max(100, len(docs) + 1)),
        info_out=info,
    )
    assert info.get("mode") == "buffer", info
    return info["encoded"]


def _new_docs(n, seed, dim=32, length=7):
    rng = np.random.default_rng(seed)
    docs = rng.standard_normal((n, length, dim)).astype(np.float32)
    return list(docs / np.linalg.norm(docs, axis=-1, keepdims=True))


def _assert_layout(ours, ref):
    """Every host field and every shard's arrays equal the JAX package's
    stacked [S, ...] arrays. Past a shard's live docs the JAX package's
    doc_offsets hold its append's power-of-two window (a compile key); the
    port's repeat the shard's total, as a fresh shard's do."""
    assert ours.n_shards == ref.n_shards
    for name in ("shard_capacity", "num_documents", "max_shard_embeddings", "max_shard_docs",
                 "ivf_stale", "static"):
        assert getattr(ours, name) == getattr(ref, name), name
    for name in ("doc_base", "shard_docs", "shard_embs"):
        np.testing.assert_array_equal(getattr(ours, name), np.asarray(getattr(ref, name)), name)
    for s, shard in enumerate(ours.shards):
        for f in SHARDED_FIELDS:
            got, want = getattr(shard, f).numpy(), np.asarray(ref.arrays[f][s])
            if f == "doc_offsets":
                live = shard.num_documents + 1
                np.testing.assert_array_equal(got[live:], shard.num_embeddings, f)
                got, want = got[:live], want[:live]
            np.testing.assert_array_equal(got, want, f)
        for f in REPLICATED_FIELDS:
            np.testing.assert_array_equal(getattr(shard, f).numpy(), np.asarray(ref.arrays[f]), f)
        assert (shard.num_documents, shard.num_embeddings) == (
            int(ref.shard_docs[s]), int(ref.shard_embs[s]))


def _sharded_pair(corpus, capacity_factor=1.0, path=None):
    _, src, jmesh, pmesh = corpus
    path = path or src
    return (ShardedIndex.shard(HostIndexData.load(path), pmesh, capacity_factor),
            JP.ShardedIndex.shard(JP.HostIndexData.load(path), jmesh, capacity_factor))


def _cut_ties(sindex, queries, params):
    """Global ids of the docs whose approximate (cell-weight) score ties a
    prune cut (the pool-th or keep-th best of a query on a shard) within TIE
    where more docs tie than the cut keeps, scored by plain numpy from the
    port's cells on each shard. Every query of a batch is scored against the
    union of its shard's survivors, so a tie can move any query's list: the
    set is the batch's, one copy a query."""
    q_arr, q_mask = TS._pad_queries(queries, sindex.dim)
    shapes = TS.PipelineShapes.derive(
        sindex.local_index_template(), params, q_arr.shape[0], q_arr.shape[1])
    q, m = torch.from_numpy(q_arr), torch.from_numpy(q_mask)
    tied = set()
    for base, shard in zip(sindex.doc_base, sindex.shards):
        k = shard.num_centroids
        s_masked = (q @ shard.centroids.T).masked_fill(~m[:, :, None], float("-inf"))
        cells, weights = TS._dedup_cells(*TS._select_cells(s_masked, m, shapes, k), k)
        approx = _cells_scores({"arrays": shard}, cells.numpy(), weights.numpy(),
                               shapes.posting_budget)
        for row in approx[: len(queries)]:
            live = np.sort(row[np.isfinite(row)])[::-1]
            for cut in {shapes.prune_pool, shapes.prune_keep}:
                if len(live) > cut and live[cut] >= live[cut - 1] - TIE:
                    near = np.nonzero(np.abs(row - live[cut - 1]) <= TIE)[0]
                    tied |= set((near + base).tolist())
    return [tied] * len(queries)


@pytest.mark.parametrize("capacity_factor", [1.0, 1.5])
def test_shard_layout_matches_jax(corpus, capacity_factor):
    _assert_layout(*_sharded_pair(corpus, capacity_factor))


def test_host_index_data_load_matches_jax(corpus):
    path = corpus[1]
    ours, ref = HostIndexData.load(path), JP.HostIndexData.load(path)
    for f in HOST_FIELDS:
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f), f)
        assert getattr(ours, f).dtype == getattr(ref, f).dtype, f
    assert ours.nbits == ref.nbits


@pytest.mark.parametrize("subset", [False, True])
def test_exact_search_matches_jax(corpus, subset):
    docs = corpus[0]
    psi, jsi = _sharded_pair(corpus)
    queries, targets = make_queries(docs, num_queries=12, seed=5)
    ids = sorted(set(range(0, len(docs), 3)) | set(targets)) if subset else None
    ours = search_batch_sharded(psi, queries, SearchParameters(top_k=10, mode="exact"), subset=ids)
    ref = JP.search_batch_sharded(jsi, queries, J.SearchParameters(top_k=10, mode="exact"),
                                  subset=ids)
    _assert_same_topk(ours, ref)


@pytest.mark.parametrize("case", sorted(STAGED_CASES))
def test_staged_search_matches_jax(corpus, case):
    docs = corpus[0]
    psi, jsi = _sharded_pair(corpus)
    queries, _ = make_queries(docs, num_queries=12, seed=6)
    params = dict(top_k=10, mode="staged", stage1_precision="highest", **STAGED_CASES[case])
    ours = search_batch_sharded(psi, queries, SearchParameters(**params))
    ref = JP.search_batch_sharded(jsi, queries, J.SearchParameters(**params))
    _assert_same_topk_but_cut_ties(ours, ref, _cut_ties(psi, queries, SearchParameters(**params)))


def _grid_pair(corpus, dtype, path=None):
    _, src, jmesh, pmesh = corpus
    path = path or src
    return (ShardedGridIndex.shard_grid_only(path, pmesh, dtype),
            JP.ShardedGridIndex.shard_grid_only(path, jmesh, dtype))


def _carried(ref, mesh):
    """The port's ShardedGridIndex over the JAX package's shards: bf16 grids
    as they are, int8 ones converted to the doc-major layout, bit for bit."""
    if ref.is_int8:
        grids, scales = zip(*(
            int8_grid_from_interleaved(
                torch.from_numpy(np.array(ref.grid[s])),
                torch.from_numpy(np.array(ref.scales[s]).astype(np.float32)).to(torch.bfloat16))
            for s in range(ref.n_shards)))
    else:
        grids = [torch.from_numpy(np.array(ref.grid[s]).astype(np.float32)).to(torch.bfloat16)
                 for s in range(ref.n_shards)]
        scales = [None] * ref.n_shards
    return ShardedGridIndex(
        mesh=mesh, grids=list(grids), scales=list(scales),
        doclens=[torch.from_numpy(np.array(ref.doclens[s, :, 0])) for s in range(ref.n_shards)],
        num_documents=ref.num_documents, num_embeddings=ref.num_embeddings,
        doc_base_host=ref.doc_base_host, shard_docs_host=ref.shard_docs_host,
    )


def _assert_grids_close(ours, ref):
    """Every shard's grid against the JAX package's: bf16 equal up to one
    bf16 rounding of f32 values that agree to 1e-6; int8 (un-interleaved)
    within one step, scales equal."""
    assert ours.rows == ref.rows and ours.grid_td == ref.grid_td
    for s in range(ours.n_shards):
        np.testing.assert_array_equal(ours.doclens[s].numpy(), np.asarray(ref.doclens[s, :, 0]))
        if ours.is_int8:
            want, want_s = _carried(ref, ours.mesh).grids[s], _carried(ref, ours.mesh).scales[s]
            diff = (ours.grids[s].int() - want.int()).abs()
            assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) > 0.999
            assert torch.equal(ours.scales[s], want_s)
        else:
            want = np.asarray(ref.grid[s]).astype(np.float32)
            got = ours.grids[s].float().numpy()
            np.testing.assert_allclose(got, want, rtol=2**-7, atol=1e-6)
            assert (got == want).mean() > 0.999


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_grid_shards_match_jax(corpus, dtype):
    ours, ref = _grid_pair(corpus, dtype)
    _assert_grids_close(ours, ref)
    np.testing.assert_array_equal(ours.doc_base_host, ref.doc_base_host)
    np.testing.assert_array_equal(ours.shard_docs_host, ref.shard_docs_host)


@pytest.mark.parametrize("subset", [False, True])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_grid_search_matches_jax(corpus, dtype, subset):
    """The port's search over the JAX shards carried across; scores within
    RTOL, ATOL."""
    docs, _, _, pmesh = corpus
    ref_sg = _grid_pair(corpus, dtype)[1]
    ours_sg = _carried(ref_sg, pmesh)
    queries, targets = make_queries(docs, num_queries=12, seed=7)
    ids = sorted(set(range(1, len(docs), 4)) | set(targets)) if subset else None
    ours = search_batch_sharded_grid(ours_sg, queries, SearchParameters(top_k=10), subset=ids)
    ref = JP.search_batch_sharded_grid(ref_sg, queries, J.SearchParameters(top_k=10), subset=ids)
    _assert_same_topk(ours, ref)


def test_lloyd_sharded_matches_jax(corpus):
    jmesh, pmesh = corpus[2], corpus[3]
    rng = np.random.default_rng(8)
    data = rng.standard_normal((2000, 16)).astype(np.float32)
    init = data[::50].copy()
    np.testing.assert_allclose(
        lloyd_sharded(data, init, iters=4, mesh=pmesh),
        JP.lloyd_sharded(data, init, iters=4, mesh=jmesh), rtol=0, atol=1e-4)


def test_staged_append_and_refresh_match_jax(corpus, tmp_path):
    """In-place append + refresh_ivf: the shards' arrays, host fields and
    results equal the JAX package's functional append's."""
    docs, path = corpus[0], corpus[1]
    new = _new_docs(5, seed=31)
    encoded = _encode_batch(new, path, tmp_path)
    psi, jsi = _sharded_pair(corpus, capacity_factor=1.5)
    p_grown, j_grown = psi.append_batch(*encoded), jsi.append_batch(*encoded)
    assert p_grown is not None and j_grown is not None
    _assert_layout(p_grown, j_grown)
    assert psi.num_documents == len(docs) and not psi.ivf_stale
    queries = [new[0], new[3][:5], docs[10][:4]]
    stale = SearchParameters(top_k=10, mode="staged")
    _assert_same_topk(search_batch_sharded(p_grown, queries, stale),
                      JP.search_batch_sharded(j_grown, queries, J.SearchParameters(top_k=10,
                                                                                   mode="staged")))
    p_fresh, j_fresh = p_grown.refresh_ivf(), j_grown.refresh_ivf()
    _assert_layout(p_fresh, j_fresh)
    ours = search_batch_sharded(p_fresh, queries, stale)
    ref = JP.search_batch_sharded(j_fresh, queries, J.SearchParameters(top_k=10, mode="staged"))
    _assert_same_topk_but_cut_ties(ours, ref, _cut_ties(p_fresh, queries, stale))
    assert ours[0].passage_ids[0] == len(docs)


def test_refresh_ivf_leaves_the_predecessor_answering(corpus, tmp_path):
    """A service serves the pre-append index until its appended and
    refreshed successor replaces it: the predecessor's IVF tensors and its
    staged results stay as they were, and the new docs are not among them."""
    docs, path = corpus[0], corpus[1]
    new = _new_docs(5, seed=37)
    encoded = _encode_batch(new, path, tmp_path)
    psi, _ = _sharded_pair(corpus, capacity_factor=1.5)
    tail = psi.shards[-1]
    ivf_before = (tail.ivf_doc_ids.clone(), tail.ivf_offsets.clone())
    queries = [new[0], new[3][:5], docs[10][:4]]
    staged = SearchParameters(top_k=10, mode="staged")
    before = search_batch_sharded(psi, queries, staged)
    fresh = psi.append_batch(*encoded).refresh_ivf()
    assert fresh is not None and not fresh.ivf_stale
    assert search_batch_sharded(fresh, queries, staged)[0].passage_ids[0] == len(docs)
    assert torch.equal(tail.ivf_doc_ids, ivf_before[0])
    assert torch.equal(tail.ivf_offsets, ivf_before[1])
    after = search_batch_sharded(psi, queries, staged)
    for a, b in zip(after, before):
        assert a.passage_ids == b.passage_ids
        np.testing.assert_array_equal(a.scores, b.scores)
        assert max(a.passage_ids) < len(docs)


def test_staged_append_declines_as_jax(corpus, tmp_path):
    """Without slack both packages decline a batch (None); an older object
    of an appended family refuses to write over its successor's rows."""
    encoded = _encode_batch(_new_docs(64, seed=33, length=9), corpus[1], tmp_path)
    psi, jsi = _sharded_pair(corpus)
    assert psi.append_batch(*encoded) is None and jsi.append_batch(*encoded) is None
    psi, _ = _sharded_pair(corpus, capacity_factor=1.5)
    small = _encode_batch(_new_docs(2, seed=34), corpus[1], tmp_path / "b")
    assert psi.append_batch(*small) is not None
    with pytest.raises(Exception, match="append to the newest index"):
        psi.append_batch(*small)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_grid_append_matches_jax(corpus, dtype, tmp_path):
    docs, path = corpus[0], corpus[1]
    new = _new_docs(16, seed=35)
    encoded = _encode_batch(new, path, tmp_path)
    ours, ref = _grid_pair(corpus, dtype)
    p_grown, j_grown = ours.append_batch(*encoded), ref.append_batch(*encoded)
    assert p_grown is not None and j_grown is not None
    assert (p_grown.num_documents, p_grown.num_embeddings) == (
        j_grown.num_documents, j_grown.num_embeddings)
    np.testing.assert_array_equal(p_grown.doc_base_host, j_grown.doc_base_host)
    np.testing.assert_array_equal(p_grown.shard_docs_host, j_grown.shard_docs_host)
    _assert_grids_close(p_grown, j_grown)
    assert ours.num_documents == len(docs)
    queries = [new[2], new[9][:4], docs[5][:4]]
    p_grown = _carried(j_grown, ours.mesh)
    _assert_same_topk(search_batch_sharded_grid(p_grown, queries, SearchParameters(top_k=10)),
                      JP.search_batch_sharded_grid(j_grown, queries, J.SearchParameters(top_k=10)))


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_grid_append_spills_as_jax(corpus, dtype, tmp_path):
    """A 10-doc corpus leaves empty shards; a batch of a shard's rows fills
    the tail shard's slack and spills into its successors at the JAX
    package's boundaries."""
    jmesh, pmesh = corpus[2], corpus[3]
    path = str(tmp_path / "tiny")
    J.create_index(make_corpus(num_docs=10, seed=3), path, J.IndexConfig(nbits=4, seed=42))
    ours = ShardedGridIndex.shard_grid_only(path, pmesh, dtype)
    ref = JP.ShardedGridIndex.shard_grid_only(path, jmesh, dtype)
    new = make_corpus(num_docs=ours.rows, seed=19)
    encoded = _encode_batch(new, path, tmp_path)
    p_grown, j_grown = ours.append_batch(*encoded), ref.append_batch(*encoded)
    assert p_grown is not None and j_grown is not None
    assert np.count_nonzero(p_grown.shard_docs_host) > np.count_nonzero(ours.shard_docs_host)
    np.testing.assert_array_equal(p_grown.doc_base_host, j_grown.doc_base_host)
    np.testing.assert_array_equal(p_grown.shard_docs_host, j_grown.shard_docs_host)
    _assert_grids_close(p_grown, j_grown)


def test_grid_append_declines_as_jax(corpus, tmp_path):
    """None where the JAX package returns it: a doc longer than the grid's
    token axis, an immutable construction, and the rows exhausted."""
    import dataclasses

    ours, ref = _grid_pair(corpus, "bf16")
    rng = np.random.default_rng(0)
    long_doc = rng.standard_normal((ours.grid_td + 1, 32)).astype(np.float32)
    long_doc /= np.linalg.norm(long_doc, axis=1, keepdims=True)
    encoded = _encode_batch([long_doc], corpus[1], tmp_path)
    assert ours.append_batch(*encoded) is None and ref.append_batch(*encoded) is None
    assert dataclasses.replace(ours, centroids_host=None).append_batch(*encoded) is None
    many = _encode_batch(make_corpus(num_docs=8 * ours.rows, seed=4), corpus[1], tmp_path / "m")
    assert ours.append_batch(*many) is None and ref.append_batch(*many) is None


def test_empty_shards_score_nothing_and_plan_a_launch(corpus, tmp_path):
    """A shard with few or no live rows: the kernel's plain version scores
    its empty rows 0 (doclens 0 / scale 0), the search masks them, and
    `plan_launch` plans the shard's full rows at the index's Td."""
    path = str(tmp_path / "tiny")
    J.create_index(make_corpus(num_docs=10, seed=3), path, J.IndexConfig(nbits=4, seed=42))
    for dtype in ("bf16", "int8"):
        sg = ShardedGridIndex.shard_grid_only(path, corpus[3], dtype)
        assert sg.shard_docs_host[-1] == 0
        q = torch.from_numpy(TS._pad_queries(make_queries(make_corpus(10, seed=3))[0], 32)[0])
        scores = PS.shard_grid_scores(sg, sg.n_shards - 1, q)
        assert scores.shape == (q.shape[0], sg.rows) and not scores.any()
        plan = plan_launch(q.shape[0], q.shape[1], sg.rows, 128, scales=sg.is_int8)
        assert plan.dpb >= 1 and plan.smem <= SMEM_LIMIT
        res = search_batch_sharded_grid(sg, make_queries(make_corpus(10, seed=3))[0],
                                        SearchParameters(top_k=20))
        assert all(len(r.passage_ids) == 10 for r in res)


def test_entry_points_raise_without_a_card(monkeypatch):
    from nextplaid_tpu_torch.parallel import init_distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    for var in ("NEXT_PLAID_COORDINATOR", "NEXT_PLAID_NUM_PROCESSES", "NEXT_PLAID_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() is False
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_distributed("localhost:1", 2, 0)


def test_single_process_collectives():
    mesh = make_mesh(devices=["cpu"] * 3)
    assert (mesh.size, mesh.local_shards, mesh.group) == (3, range(0, 3), None)
    tiles = [torch.full((2, 4), float(s)) for s in range(3)]
    assert torch.equal(mesh.all_gather(tiles), torch.stack(tiles))
    assert torch.equal(mesh.sum(tiles), torch.full((2, 4), 3.0))
