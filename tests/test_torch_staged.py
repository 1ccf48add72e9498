"""The staged PLAID pipeline of the port against the JAX package's, stage by
stage and end to end, on an index built by the JAX package and carried
across (from its arrays, and from disk).

Everything runs in f32 ("highest") unless a test says otherwise, so scores
agree to rtol 1e-5, atol 1e-4 (f32 sums in other orders; |scores| < 40).
Cuts (the prune at pool/keep, an explicit max_candidates) are compared as
sets modulo ties: the JAX package sums a doc's cell weights as differences
of an f32 running sum over the whole posting stream, whose rounding breaks
exact ties arbitrarily, so a doc may be in one survivor set only if its
approximate score is within 1e-4 of the cut's. The stage-4 kernel route
scores a bf16 grid with bf16 queries in both packages (the Pallas kernel in
interpret mode there, the kernel's plain version here): tolerance 2e-2.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nextplaid_tpu.index as J
from nextplaid_tpu.index import search as JS
from nextplaid_tpu_torch.index import (
    DeviceIndex,
    SearchParameters,
    search_batch,
    search_batch_async,
)
from nextplaid_tpu_torch.index import search as TS
from nextplaid_tpu_torch.ops.maxsim_kernel import maxsim_grid_scores
from nextplaid_tpu_torch.utils.errors import SearchError

RTOL, ATOL = 1e-5, 1e-4
TIE = 1e-4
NUM_DOCS, NUM_TOPICS, DIM = 240, 24, 32
STAGED = dict(top_k=10, mode="staged", stage1_precision="highest")
# Fields of PipelineShapes that decide which documents come back.
DECIDING = (
    "nprobe", "posting_budget", "prune_keep", "prune_pool", "max_candidates",
    "top_k", "doc_token_cap", "threshold", "approx_score", "candidate_scope",
    "overflow_policy", "stage1_precision", "nbits",
)
# Whether each `kernel` value takes the hand-written kernels on the CPU.
KERNEL_CHOICE = {"auto": False, "pallas": True, "xla": False, "off": False}


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    rng = np.random.default_rng(0)
    topics = _unit(rng.standard_normal((NUM_TOPICS, DIM))).astype(np.float32)

    def sample(lo, hi):
        n = int(rng.integers(lo, hi))
        t = topics[rng.integers(0, NUM_TOPICS, n)] + 0.15 * rng.standard_normal((n, DIM))
        return _unit(t).astype(np.float32)

    docs = [sample(8, 41) for _ in range(NUM_DOCS)]
    queries = [sample(5, 33) for _ in range(12)]
    path = str(tmp_path_factory.mktemp("staged") / "idx")
    J.create_index(docs, path, J.IndexConfig(nbits=4, seed=42))
    ref = J.DeviceIndex.load(path)
    names = ("centroids", "codes", "residuals", "doc_offsets", "doclens",
             "ivf_offsets", "ivf_doc_ids", "bucket_cutoffs", "bucket_weights",
             "avg_residual")
    carried = DeviceIndex.from_reference_arrays(
        {n: np.asarray(getattr(ref, n)) for n in names},
        nbits=ref.nbits, max_doclen=ref.max_doclen,
        num_documents=ref.num_documents, num_embeddings=ref.num_embeddings,
        device="cpu",
    )
    loaded = DeviceIndex.load(path, device="cpu")
    return dict(queries=queries, ref=ref, arrays=carried, disk=loaded)


def _assert_same_topk(ours, ref, k=10, rtol=RTOL, atol=ATOL):
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        assert len(o.passage_ids) == len(r.passage_ids) == k
        np.testing.assert_allclose(o.scores, r.scores, rtol=rtol, atol=atol)
        o_map = dict(zip(o.passage_ids, o.scores))
        r_map = dict(zip(r.passage_ids, r.scores))
        kth = r.scores[-1]
        for doc in set(o_map) ^ set(r_map):
            score = o_map.get(doc, r_map.get(doc))
            assert abs(score - kth) <= atol + rtol * abs(kth), (doc, score, kth)
        for doc in set(o_map) & set(r_map):
            assert abs(o_map[doc] - r_map[doc]) <= atol + rtol * abs(r_map[doc])


def _stage12(built, params, num_queries=12):
    """Padded queries and stages 1-2 in both packages. Returns a dict with
    each side's shapes, masked centroid scores, cells and weights."""
    ref, ours, queries = built["ref"], built["arrays"], built["queries"][:num_queries]
    q_arr, q_mask = TS._pad_queries(queries, DIM)
    k = ref.num_centroids
    jsh = JS.PipelineShapes.derive(ref, J.SearchParameters(**params), len(queries), q_arr.shape[1])
    tsh = TS.PipelineShapes.derive(ours, SearchParameters(**params), len(queries), q_arr.shape[1])
    jq, jm = jnp.asarray(q_arr), jnp.asarray(q_mask)
    js = jnp.where(
        jm[:, :, None],
        jnp.einsum("qtd,kd->qtk", jq, ref.centroids, precision=jax.lax.Precision.HIGHEST),
        -jnp.inf,
    )
    tq_, tm = torch.from_numpy(q_arr), torch.from_numpy(q_mask)
    ts = (tq_.reshape(-1, DIM) @ ours.centroids.T).view(len(queries), -1, k)
    ts = ts.masked_fill(~tm[:, :, None], float("-inf"))
    jc, jw = JS._dedup_cells(*JS._select_cells(js, jm, jsh, k), k)
    tc, tw = TS._dedup_cells(*TS._select_cells(ts, tm, tsh, k), k)
    return dict(jsh=jsh, tsh=tsh, js=js, ts=ts, jq=jq, jm=jm, tq=tq_, tm=tm,
                jc=jc, jw=jw, tc=tc, tw=tw)


def _prune_both(built, s, jsh=None, tsh=None):
    ju, jo, jmine = JS._prune_candidates(
        built["ref"], s["jc"], s["jw"], jsh or s["jsh"], s_masked=s["js"],
        qmask=s["jm"], queries=s["jq"])
    tu, to, tmine = TS._prune_candidates(
        built["arrays"], s["tc"], s["tw"], tsh or s["tsh"], s_masked=s["ts"], qmask=s["tm"])
    return (np.asarray(ju), int(jo), None if jmine is None else np.asarray(jmine),
            tu.numpy(), int(to), None if tmine is None else tmine.numpy())


def _cells_scores(built, cells, weights, budget):
    """[Q, docs] cells-mode approximate scores by plain numpy: the weights of
    the probed cells whose posting list holds the doc, over the first
    `budget` entries of the weight-ordered stream; -inf for unprobed docs."""
    index = built["arrays"]
    offs = index.ivf_offsets.numpy()
    ivf = index.ivf_doc_ids.numpy()
    k = index.num_centroids
    out = np.full((cells.shape[0], index.num_documents), -np.inf)
    for q in range(cells.shape[0]):
        left = budget
        for c, w in zip(cells[q], weights[q]):
            if c >= k or left <= 0:
                continue
            docs = ivf[offs[c] : offs[c + 1]][:left]
            left -= len(docs)
            cur = out[q, docs]
            out[q, docs] = np.where(np.isfinite(cur), cur, 0.0) + w
    return out


def _assert_sets_equal_modulo_ties(got, want, scores, cut):
    """`got` and `want` (sets of doc ids) may differ only in docs whose
    score ties the cut's (the `cut`-th best score) within TIE."""
    if got == want:
        return
    kth = np.sort(scores[np.isfinite(scores)])[::-1][cut - 1]
    for doc in got ^ want:
        assert abs(scores[doc] - kth) <= TIE, (doc, scores[doc], kth)
    assert len(got) == len(want)


# ---------------------------------------------------------------------------
# Index statistics and shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source", ["arrays", "disk"])
def test_posting_stats_match_jax(built, source):
    ref, ours = built["ref"], built[source]
    assert ours.max_posting_len == ref.max_posting_len > 0
    assert ours.posting_mass_prefix == ref.posting_mass_prefix
    for ncells in (1, 64, 65, 256, 4096, 4097):
        assert ours.posting_mass_bound(ncells) == ref.posting_mass_bound(ncells)


DERIVE_CASES = {
    "defaults": dict(),
    "cells": dict(approx_score="cells", n_ivf_probe=4),
    "codes_tight": dict(approx_score="codes", n_ivf_probe=2, prune_keep=8),
    "budget": dict(posting_budget=300, overflow_policy="prune"),
    "max_candidates": dict(max_candidates=40, prune_keep=16),
    "top_k_beyond": dict(top_k=5000),
    "no_threshold": dict(centroid_score_threshold=None, candidate_scope="per_query"),
    "probe_all": dict(n_ivf_probe=10**6, stage1_precision="default"),
}


@pytest.mark.parametrize("source", ["arrays", "disk"])
@pytest.mark.parametrize("case", sorted(DERIVE_CASES))
def test_derive_matches_jax(built, source, case):
    params = dict(mode="staged", **DERIVE_CASES[case])
    for nq, tq in ((8, 32), (16, 64), (64, 32)):
        want = JS.PipelineShapes.derive(built["ref"], J.SearchParameters(**params), nq, tq)
        got = TS.PipelineShapes.derive(built[source], SearchParameters(**params), nq, tq)
        for name in DECIDING + ("num_queries", "query_tokens", "cand_tile"):
            assert getattr(got, name) == getattr(want, name), name


def test_derive_codes_impl_and_rerank_kernel(built, monkeypatch):
    index = built["arrays"]
    # On the CPU only kernel="pallas" takes the kernel route (its plain
    # version); "xla"/"off" keep the scan, and the grid must fit the budget.
    flags = {
        kernel: TS.PipelineShapes.derive(index, SearchParameters(kernel=kernel), 8, 32).rerank_kernel
        for kernel in KERNEL_CHOICE
    }
    assert flags == KERNEL_CHOICE
    monkeypatch.setattr(TS, "RERANK_GRID_BYTES", 0)
    assert not TS.PipelineShapes.derive(
        index, SearchParameters(kernel="pallas"), 8, 32).rerank_kernel


@pytest.mark.parametrize("kernel", sorted(KERNEL_CHOICE))
def test_derive_reads_no_environment(built, kernel, monkeypatch):
    """The staged route's shapes follow the index, the parameters and the
    batch alone: the JAX package's TPU-only settings change nothing."""
    params = SearchParameters(kernel=kernel, approx_score="codes")
    want = TS.PipelineShapes.derive(built["arrays"], params, 8, 32)
    monkeypatch.setenv("NEXT_PLAID_CODES_IMPL", "mxu")
    monkeypatch.setenv("NEXT_PLAID_RERANK_GRID_MB", "0")
    assert TS.PipelineShapes.derive(built["arrays"], params, 8, 32) == want


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("kernel", sorted(KERNEL_CHOICE))
def test_use_kernels_by_value_and_device(kernel, device):
    """"pallas" forces the kernels, "auto" takes them on a CUDA index, "xla"
    and "off" never do."""
    want = kernel == "pallas" or (kernel == "auto" and device == "cuda")
    assert TS._use_kernels(kernel, torch.device(device)) == want


@pytest.mark.parametrize("kernel", sorted(KERNEL_CHOICE))
def test_kernel_choice_on_both_routes(built, kernel, monkeypatch):
    """On the CPU the exact route over a pinned grid and staged stage 4 make
    the same choice: the kernels for "pallas" alone."""
    seen = {}
    exact, pipeline = TS.exact_search_pipeline, TS.search_pipeline

    def exact_spy(*args, use_kernel, **kwargs):
        seen["exact"] = use_kernel
        return exact(*args, use_kernel=use_kernel, **kwargs)

    def pipeline_spy(index, queries, qmask, subset, shapes, **kwargs):
        seen["staged"] = shapes.rerank_kernel
        return pipeline(index, queries, qmask, subset, shapes, **kwargs)

    monkeypatch.setattr(TS, "exact_search_pipeline", exact_spy)
    monkeypatch.setattr(TS, "search_pipeline", pipeline_spy)
    pinned = built["arrays"].with_token_grid(budget_mb=10_000, dtype="bf16")
    queries = built["queries"][:4]
    search_batch(pinned, queries, SearchParameters(kernel=kernel, top_k=5, mode="exact"))
    search_batch(built["arrays"], queries, SearchParameters(kernel=kernel, **STAGED))
    assert seen == {"exact": KERNEL_CHOICE[kernel], "staged": KERNEL_CHOICE[kernel]}


@pytest.mark.parametrize("route", ["pinned", "unpinned", "staged"])
def test_unknown_kernel_raises_at_dispatch(built, route):
    index = built["arrays"]
    if route == "pinned":
        index = index.with_token_grid(budget_mb=10_000, dtype="bf16")
    mode = "staged" if route == "staged" else "exact"
    params = SearchParameters(kernel="cuda", top_k=5, mode=mode)
    with pytest.raises(SearchError, match="auto, pallas, xla, off"):
        search_batch_async(index, built["queries"][:2], params)


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    dict(), dict(n_ivf_probe=2), dict(centroid_score_threshold=None),
    dict(centroid_score_threshold=0.6, n_ivf_probe=16),
], ids=["default", "nprobe2", "no_threshold", "threshold0.6_nprobe16"])
def test_select_and_dedup_cells_match_jax(built, case):
    s = _stage12(built, dict(STAGED, **case))
    tc, jc = s["tc"].numpy(), np.asarray(s["jc"])
    # Merged weights: the JAX package takes differences of an f32 running sum
    # over the row (sums up to ~100, so ~3e-5 of rounding); this package sums
    # each run exactly. 1e-4 covers it.
    np.testing.assert_allclose(s["tw"].numpy(), np.asarray(s["jw"]), rtol=0, atol=1e-4)
    # Equal cells in equal order, except where two cells' merged weights tie
    # within that tolerance and swap places.
    np.testing.assert_array_equal(np.sort(tc, axis=1), np.sort(jc, axis=1))
    for q, i in zip(*np.nonzero(tc != jc)):
        (j,) = np.nonzero(jc[q] == tc[q, i])[0]
        assert abs(s["tw"].numpy()[q, i] - s["tw"].numpy()[q, j]) <= 1e-4
    assert s["tw"].dtype == torch.float32
    # Descending weights, sentinels carry 0.
    k = built["ref"].num_centroids
    assert (np.diff(s["tw"].numpy(), axis=1) <= 0).all()
    assert (s["tw"].numpy()[s["tc"].numpy() == k] == 0).all()


@pytest.mark.parametrize("scope", ["batch", "per_query"])
@pytest.mark.parametrize("approx", ["cells", "codes"])
@pytest.mark.parametrize("budget", [0, 128], ids=["ample", "tight"])
def test_prune_candidates_matches_jax(built, approx, scope, budget):
    """No cut at pool/keep (keep covers every probed doc): equal union,
    overflow and membership; at the tight budget the weight-sorted tail of
    the posting stream is truncated and counted."""
    s = _stage12(built, dict(STAGED, approx_score=approx, candidate_scope=scope,
                             posting_budget=budget, n_ivf_probe=4))
    ju, jo, jmine, tu, to, tmine = _prune_both(built, s)
    np.testing.assert_array_equal(tu, ju)
    assert to == jo and (to > 0) == (budget > 0)
    if scope == "per_query":
        np.testing.assert_array_equal(tmine, jmine)
    else:
        assert tmine is None and jmine is None
    # Sorted ids, the sentinel slot in the tail.
    assert (np.diff(tu) >= 0).all() and tu[-1] == built["ref"].num_docs_padded - 1


@pytest.mark.parametrize("budget", [0, 256], ids=["ample", "tight"])
def test_prune_cells_cut_matches_jax_modulo_ties(built, budget):
    """A tight keep in "cells" mode: each query's survivors are the top-keep
    docs by summed cell weight, equal to the JAX package's up to ties."""
    keep = 12
    s = _stage12(built, dict(STAGED, approx_score="cells", candidate_scope="per_query",
                             prune_keep=keep, posting_budget=budget, n_ivf_probe=4))
    assert s["tsh"].prune_keep == keep
    ju, jo, jmine, tu, to, tmine = _prune_both(built, s)
    assert to == jo
    scores = _cells_scores(built, s["tc"].numpy(), s["tw"].numpy(), s["tsh"].posting_budget)
    nd_live = built["ref"].num_documents
    for q in range(len(scores)):
        got = {int(d) for d in tu[tmine[q]] if d < nd_live}
        want = {int(d) for d in ju[jmine[q]] if d < nd_live}
        best = set(np.argsort(-scores[q], kind="stable")[:keep].tolist())
        assert len(got) == min(keep, int(np.isfinite(scores[q]).sum()))
        _assert_sets_equal_modulo_ties(got, want, scores[q], keep)
        _assert_sets_equal_modulo_ties(got, best, scores[q], keep)


def test_approx_codes_scores_match_jax(built):
    """Stage 3b on the same candidates: both packages look up f32 scores
    (1e-5)."""
    s = _stage12(built, dict(STAGED, approx_score="codes"))
    jsh = dataclasses.replace(s["jsh"], prune_pool=48)
    tsh = dataclasses.replace(s["tsh"], prune_pool=48)
    rng = np.random.default_rng(1)
    cand = rng.integers(0, NUM_DOCS, (12, 48))
    cand[:, -3:] = built["ref"].num_docs_padded - 1  # sentinel slots
    want = JS._approx_codes_scores(
        built["ref"], s["js"], s["jm"], jnp.asarray(cand, jnp.int32), jsh, queries=s["jq"])
    got = TS._approx_codes_scores(
        built["arrays"], s["ts"], s["tm"], torch.from_numpy(cand), tsh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert (got.numpy()[:, -3:] == 0).all()


def test_prune_codes_cut_matches_jax_modulo_ties(built):
    """A tight keep in "codes" mode with a pool that holds every doc (so only
    the 3b cut decides): survivors equal the JAX package's up to ties in the
    codes score."""
    keep = 60  # pool = min(4 * keep, docs) = every doc
    s = _stage12(built, dict(STAGED, approx_score="codes", candidate_scope="per_query",
                             prune_keep=keep, n_ivf_probe=4))
    assert s["tsh"].prune_pool == NUM_DOCS and s["tsh"].prune_keep == keep
    ju, _, jmine, tu, _, tmine = _prune_both(built, s)
    all_docs = torch.arange(NUM_DOCS)[None, :].repeat(12, 1)
    codes = TS._approx_codes_scores(
        built["arrays"], s["ts"], s["tm"], all_docs, s["tsh"]).numpy()
    probed = np.isfinite(_cells_scores(
        built, s["tc"].numpy(), s["tw"].numpy(), s["tsh"].posting_budget))
    cut_somewhere = False
    for q in range(12):
        scores = np.where(probed[q], codes[q], -np.inf)
        got = {int(d) for d in tu[tmine[q]] if d < NUM_DOCS}
        want = {int(d) for d in ju[jmine[q]] if d < NUM_DOCS}
        assert len(got) == min(keep, int(probed[q].sum()))
        cut_somewhere |= int(probed[q].sum()) > keep
        _assert_sets_equal_modulo_ties(got, want, scores, keep)
    assert cut_somewhere


@pytest.mark.parametrize("approx", ["cells", "codes"])
def test_explicit_max_candidates_truncates_union(built, approx):
    """max_candidates below the union: the best docs by approximate score
    across queries stay, and the truncation is counted as overflow."""
    base = dict(STAGED, approx_score=approx, n_ivf_probe=4)
    s = _stage12(built, dict(base, max_candidates=40))
    full = _stage12(built, base)
    _, _, _, tu_full, _, _ = _prune_both(built, full)
    n_union = int((tu_full < NUM_DOCS).sum())
    assert s["tsh"].max_candidates == s["jsh"].max_candidates == 40 < n_union
    ju, jo, _, tu, to, _ = _prune_both(built, s)
    assert to == jo == n_union - 40
    assert len(tu) == len(ju) == 40 and (np.diff(tu) > 0).all()
    if approx == "cells":
        scores = _cells_scores(
            built, s["tc"].numpy(), s["tw"].numpy(), s["tsh"].posting_budget).max(axis=0)
    else:
        all_docs = torch.arange(NUM_DOCS)[None, :].repeat(12, 1)
        codes = TS._approx_codes_scores(
            built["arrays"], s["ts"], s["tm"], all_docs, s["tsh"]).numpy()
        probed = np.isfinite(_cells_scores(
            built, s["tc"].numpy(), s["tw"].numpy(), s["tsh"].posting_budget))
        scores = np.where(probed, codes, -np.inf).max(axis=0)
    _assert_sets_equal_modulo_ties(set(tu.tolist()), set(ju.tolist()), scores, 40)


def test_exact_on_candidates_scan_and_kernel_routes(built):
    """Stage 4 on a union with sentinel slots: the scan equals the JAX scan
    (1e-5 / 1e-4); the kernel route (plain version on the CPU) equals the
    JAX kernel route in interpret mode and the scan within bf16 tolerance
    2e-2; sentinel slots score 0 on every route."""
    s = _stage12(built, dict(STAGED))
    sentinel = built["ref"].num_docs_padded - 1
    union = np.concatenate([np.arange(0, NUM_DOCS, 3), np.full(16, sentinel)])
    jsh = dataclasses.replace(s["jsh"], max_candidates=len(union), cand_tile=32)
    tsh = dataclasses.replace(s["tsh"], max_candidates=len(union), cand_tile=32)
    ju, tu = jnp.asarray(union, jnp.int32), torch.from_numpy(union)
    want = np.asarray(JS._exact_on_candidates(built["ref"], s["jq"], s["jm"], ju, jsh))
    got = TS._exact_on_candidates(built["arrays"], s["tq"], s["tm"], tu, tsh).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    want_k = np.asarray(JS._exact_on_candidates_kernel(built["ref"], s["jq"], s["jm"], ju, jsh))
    before = maxsim_grid_scores.launches
    got_k = TS._exact_on_candidates(
        built["arrays"], s["tq"], s["tm"], tu, dataclasses.replace(tsh, rerank_kernel=True)
    ).numpy()
    assert maxsim_grid_scores.launches == before  # CPU tensors launch nothing
    np.testing.assert_allclose(got_k, want_k, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got_k, got, rtol=2e-2, atol=2e-2)
    assert (got[:, -16:] == 0).all() and (got_k[:, -16:] == 0).all()


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source", ["arrays", "disk"])
@pytest.mark.parametrize("scope", ["batch", "per_query"])
@pytest.mark.parametrize("approx", ["cells", "codes"])
def test_staged_search_matches_jax(built, approx, scope, source):
    params = dict(STAGED, approx_score=approx, candidate_scope=scope)
    want = J.search_batch(built["ref"], built["queries"], J.SearchParameters(**params))
    got = search_batch(built[source], built["queries"], SearchParameters(**params))
    _assert_same_topk(got, want)


@pytest.mark.parametrize("case", [
    dict(n_ivf_probe=2, centroid_score_threshold=None),
    dict(n_ivf_probe=4, posting_budget=256, overflow_policy="prune"),
    dict(approx_score="cells", n_ivf_probe=16, centroid_score_threshold=0.5),
], ids=["nprobe2", "tight_budget_prune", "cells_nprobe16"])
def test_staged_search_operating_points_match_jax(built, case):
    params = dict(STAGED, **case)
    want = J.search_batch(built["ref"], built["queries"], J.SearchParameters(**params))
    got = search_batch(built["arrays"], built["queries"], SearchParameters(**params))
    _assert_same_topk(got, want)


def test_stage4_kernel_route_matches_jax_interpret(built, monkeypatch):
    """search_batch with stage 4 through the kernel route in both packages:
    the JAX package's Pallas kernel in interpret mode (its derive patched to
    take the route on the CPU), the port's plain version (kernel="pallas").
    bf16 grid and queries on both sides: tolerance 2e-2."""
    orig = JS.PipelineShapes.derive.__func__
    monkeypatch.setattr(
        JS.PipelineShapes, "derive",
        classmethod(lambda cls, i, p, nq, qt: dataclasses.replace(
            orig(cls, i, p, nq, qt), rerank_kernel=True)),
    )
    params = dict(STAGED, top_k=5)
    want = J.search_batch(built["ref"], built["queries"], J.SearchParameters(**params))
    got = search_batch(built["arrays"], built["queries"],
                       SearchParameters(kernel="pallas", **params))
    _assert_same_topk(got, want, k=5, rtol=2e-2, atol=2e-2)
    scan = search_batch(built["arrays"], built["queries"],
                        SearchParameters(kernel="xla", **params))
    _assert_same_topk(got, scan, k=5, rtol=2e-2, atol=2e-2)


def test_staged_probing_every_cell_equals_exact(built):
    index = built["arrays"]
    params = dict(top_k=10, stage1_precision="highest", centroid_score_threshold=None)
    staged = search_batch(index, built["queries"], SearchParameters(
        mode="staged", n_ivf_probe=index.num_centroids, approx_score="cells", **params))
    exact = search_batch(index, built["queries"], SearchParameters(mode="exact", **params))
    _assert_same_topk(staged, exact)


def test_staged_subset_matches_jax(built):
    subset = list(range(0, NUM_DOCS, 3))
    params = dict(STAGED, top_k=5)
    want = J.search_batch(built["ref"], built["queries"], J.SearchParameters(**params),
                          subset=subset)
    got = search_batch(built["arrays"], built["queries"], SearchParameters(**params),
                       subset=subset)
    _assert_same_topk(got, want, k=5)
    assert all(set(r.passage_ids) <= set(subset) for r in got)


def test_staged_top_k_beyond_corpus(built):
    """More results asked for than docs exist: every probed doc once, -1
    slots dropped, as in the JAX package."""
    params = dict(STAGED, top_k=5000, centroid_score_threshold=None)
    want = J.search_batch(built["ref"], built["queries"][:3], J.SearchParameters(**params))
    got = search_batch(built["arrays"], built["queries"][:3], SearchParameters(**params))
    for o, r in zip(got, want):
        assert 0 < len(o.passage_ids) <= NUM_DOCS
        assert len(set(o.passage_ids)) == len(o.passage_ids)
        assert sorted(o.passage_ids) == sorted(r.passage_ids)
        np.testing.assert_allclose(o.scores, r.scores, rtol=RTOL, atol=ATOL)


def test_overflow_falls_back_to_exhaustive(built, caplog):
    index = built["arrays"]
    params = dict(top_k=10, stage1_precision="highest", posting_budget=128)
    pending = search_batch_async(index, built["queries"], SearchParameters(
        mode="staged", overflow_policy="exact", **params))
    assert int(pending.overflow.max()) > 0
    with caplog.at_level(logging.WARNING):
        got = pending.result()
    assert "posting-budget overflow" in caplog.text
    exact = search_batch(index, built["queries"], SearchParameters(mode="exact", **params))
    assert [r.passage_ids for r in got] == [r.passage_ids for r in exact]
    want = J.search_batch(built["ref"], built["queries"], J.SearchParameters(
        mode="staged", overflow_policy="exact", **params))
    _assert_same_topk(got, want)
    # "prune" keeps the truncated stream's answer and reports nothing.
    caplog.clear()
    pruned = search_batch(index, built["queries"], SearchParameters(
        mode="staged", overflow_policy="prune", **params))
    assert "posting-budget overflow" not in caplog.text
    assert len(pruned) == len(got)


def test_staged_async_pipelining(built):
    index = built["arrays"]
    params = SearchParameters(**STAGED)
    halves = [built["queries"][:6], built["queries"][6:]]
    pending = [search_batch_async(index, h, params) for h in halves * 2]
    sync = [search_batch(index, h, params) for h in halves]
    for i, p in enumerate(pending):
        assert p.shapes is not None and p.shapes.num_queries == 6
        assert [r.passage_ids for r in p.result()] == [r.passage_ids for r in sync[i % 2]]
    assert search_batch_async(index, [], params).result() == []


def test_auto_above_exact_max_embeddings_routes_to_staged(built):
    index = built["arrays"]
    auto = SearchParameters(mode="auto", exact_max_embeddings=0, stage1_precision="highest")
    pending = search_batch_async(index, built["queries"], auto)
    assert pending.shapes is not None  # the staged route
    staged = search_batch(index, built["queries"], dataclasses.replace(auto, mode="staged"))
    assert [r.passage_ids for r in pending.result()] == [r.passage_ids for r in staged]
    below = search_batch_async(index, built["queries"], dataclasses.replace(
        auto, exact_max_embeddings=10**9))
    assert below.shapes is None  # the exhaustive route


@pytest.mark.parametrize("preset", ["latency", "balanced", "quality", "exact"])
def test_presets_match_jax(built, preset):
    kw = dict(mode="staged" if preset != "exact" else "auto",
              exact_max_embeddings=0, stage1_precision="highest")
    want = J.search_batch(built["ref"], built["queries"],
                          J.SearchParameters.preset(preset, **kw))
    pending = search_batch_async(built["arrays"], built["queries"],
                                 SearchParameters.preset(preset, **kw))
    assert (pending.shapes is None) == (preset == "exact")
    _assert_same_topk(pending.result(), want)
