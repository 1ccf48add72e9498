"""Staged stage 3b: the CUDA kernel (csrc/approx_codes.cu,
`ops.approx_codes`) against the eager loop it replaces on a card
(`index.search._approx_codes_scores_eager`), and the eager loop kept as it is
on the CPU.

The kernel looks up the same f32 table rows and takes the same maxima as the
eager loop, and sums them over query tokens in f64, rounding once: it is held
at rtol and atol 1e-6 against the eager loop run on the table in f64, which
sums the same maxima so (the eager loop's f32 sum carries its own rounding,
past 1e-6 of a score where the terms cancel), and every score the eager
loop zeroes (masked query tokens, empty docs, ids past the live docs) is
exactly 0. The card tests run on an H100 with
`python -m pytest --noconftest -m cuda tests/test_torch_approx_codes.py`.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import types

import numpy as np
import pytest
import torch

from nextplaid_tpu_torch.index import (
    DeviceIndex,
    IndexConfig,
    SearchParameters,
    create_index,
    search_batch,
)
from nextplaid_tpu_torch.index import search as S
from nextplaid_tpu_torch.index.container import _rq_fields
from nextplaid_tpu_torch.ops import approx_codes as A
from nextplaid_tpu_torch.ops import maxsim_kernel as mk

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (its stage-3b check; imports no JAX)
# By the names pytest gives this directory's modules: a card's Python may
# have a `tests` package of its own.
from staged_compare import _assert_same_topk_but_cut_ties  # noqa: E402
from test_torch_union_grid import synthetic_index  # noqa: E402

TOL = 1e-6
TIE = 1e-5  # stage-3b scores this close to a keep cut may trade places
STAGED = dict(top_k=10, mode="staged", kernel="auto", n_ivf_probe=4, n_full_scores=64)
# A lane's 1, 2, 4 and 8 columns (two of them ragged), and two slices of
# 256 columns, the second ragged.
TQS = [32, 40, 100, 256, 288]


def stage3b_case(seed, tq, device, td=24, q_n=5, pool=77):
    """Stage 3b's inputs from a seed: the 150-doc synthetic index (doc 3
    empty, doc 4 exactly td tokens, doc 5 longer), a [Q, Tq, K] table with
    query 1 partly masked and query 2 wholly masked (-inf rows), and a pool
    of `pool` ids a query, not a multiple of a block's 8, holding those
    docs, padded rows past num_documents, ids past the padded rows and the
    pipeline's sentinel. Returns (index, s_masked, qmask, ids, shapes)."""
    rng = np.random.default_rng(seed)
    index = synthetic_index(seed, 2, 32, td, device)
    nd, nd_pad, k = index.num_documents, index.num_docs_padded, index.num_centroids
    qmask = np.ones((q_n, tq), bool)
    qmask[1, tq // 3:] = False
    qmask[2] = False
    s = rng.standard_normal((q_n, tq, k)).astype(np.float32)
    s[~qmask] = -np.inf
    ids = rng.integers(0, nd, (q_n, pool))
    ids[:, :7] = [3, 4, 5, nd, nd + 3, nd_pad + 7, nd_pad - 1]
    ids = rng.permuted(ids, axis=1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    shapes = types.SimpleNamespace(doc_token_cap=td)
    return index, t(s), t(qmask), t(ids), shapes


def test_supported_takes_cuda_batches_up_to_max_tq():
    """The kernel takes any Tq (it has no maximum), so the device alone
    decides."""
    assert A.supported(torch.device("cuda")) and A.supported(torch.device("cuda", 3))
    assert not A.supported(torch.device("cpu")) and not A.supported(torch.device("meta"))


def test_kernel_refuses_cpu_tensors():
    index, s_masked, qmask, ids, shapes = stage3b_case(0, 32, "cpu")
    before = A.approx_codes.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        A.approx_codes(s_masked.transpose(1, 2).contiguous(), qmask, ids, index.doclens,
                       index.doc_offsets, index.codes, index.num_documents, 24)
    assert A.approx_codes.launches == before


@pytest.mark.parametrize("tq", TQS)
def test_cpu_scores_take_the_eager_loop_and_match_jax(tq, monkeypatch):
    """On the CPU `_approx_codes_scores` is the eager loop, bit for bit, and
    never reaches the kernel's wrapper; it matches the JAX package's gather
    lowering on the same inputs as test_torch_staged.py holds it (1e-5), and
    the masked cases are 0."""
    import jax.numpy as jnp  # the card has no JAX: imported only here

    from nextplaid_tpu.index import search as JS

    monkeypatch.setattr(A, "approx_codes", None)  # a call would raise
    index, s_masked, qmask, ids, shapes = stage3b_case(tq, tq, "cpu")
    got = S._approx_codes_scores(index, s_masked, qmask, ids, shapes)
    assert torch.equal(got, S._approx_codes_scores_eager(index, s_masked, qmask, ids, shapes))
    ref = types.SimpleNamespace(
        **{n: jnp.asarray(getattr(index, n).numpy()) for n in ("codes", "doc_offsets", "doclens")},
        n_docs=index.num_documents, num_docs_padded=index.num_docs_padded)
    jsh = types.SimpleNamespace(**vars(shapes), codes_impl="gather")  # the JAX lowering's name
    want = JS._approx_codes_scores(ref, jnp.asarray(s_masked.numpy()), jnp.asarray(qmask.numpy()),
                                   jnp.asarray(ids.numpy(), jnp.int32), jsh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    dead = (ids >= index.num_documents) | (ids == 3)
    assert (got[2] == 0).all() and (got[dead] == 0).all() and (got[0][~dead[0]] != 0).all()


def _search_calls(monkeypatch):
    """Make every device a kernel's and stand a recorder in for the kernel:
    it records its arguments and returns the eager loop's scores."""
    calls = []

    def fake(s_t, qmask, ids, doclens, doc_offsets, codes, num_documents, td):
        calls.append(dict(s_t=s_t, qmask=qmask, ids=ids, doclens=doclens,
                          doc_offsets=doc_offsets, codes=codes, num_documents=num_documents,
                          td=td))
        return fake.eager(s_t.transpose(1, 2), qmask, ids, td)

    monkeypatch.setattr(A, "supported", lambda device: True)
    monkeypatch.setattr(A, "approx_codes", fake)
    return calls, fake


def test_gather_on_a_supported_index_routes_to_the_kernel(monkeypatch):
    """Where `supported` holds, `_approx_codes_scores` hands the transposed
    table, the mask, the pool and the index's tensors to `approx_codes` and
    returns what it returns, whatever the Tq."""
    calls, fake = _search_calls(monkeypatch)
    fake.eager = lambda *a: "scores"
    for tq in (40, 288):
        calls.clear()
        index, s_masked, qmask, ids, shapes = stage3b_case(1, tq, "cpu")
        assert S._approx_codes_scores(index, s_masked, qmask, ids, shapes) == "scores"
        (call,) = calls
        assert torch.equal(call["s_t"], s_masked.transpose(1, 2)) and call["s_t"].is_contiguous()
        assert call["qmask"] is qmask and call["ids"] is ids
        for name in ("doclens", "doc_offsets", "codes"):
            assert call[name] is getattr(index, name)
        assert (call["num_documents"], call["td"]) == (index.num_documents, 24)


@pytest.fixture(scope="module")
def built_cpu(tmp_path_factory):
    docs, queries = _corpus(np.random.default_rng(0), n_docs=120, n_queries=6)
    path = str(tmp_path_factory.mktemp("approx_codes") / "idx")
    create_index(docs, path, IndexConfig(nbits=2, seed=42), device="cpu")
    return DeviceIndex.load(path, device="cpu"), queries


def _corpus(rng, n_docs, n_queries, dim=32):
    topics = rng.standard_normal((8, dim))
    topics /= np.linalg.norm(topics, axis=1, keepdims=True)

    def sample(n):
        x = topics[rng.integers(0, 8, n)] + 0.15 * rng.standard_normal((n, dim))
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)

    docs = [sample(int(n)) for n in rng.integers(8, 40, n_docs)]
    return docs, [sample(int(n)) for n in rng.integers(5, 33, n_queries)]


def with_rq(index):
    """The same index with an RQ codebook (K = C x F): staged search then
    selects cells over the factors and has no [Q, Tq, K] table."""
    k, dim = index.num_centroids, index.dim
    c = 1 << (k.bit_length() // 2)
    rng = np.random.default_rng(3)
    return dataclasses.replace(index, **_rq_fields(
        rng.standard_normal((c, dim)), rng.standard_normal((k // c, dim)), index.device))


def test_staged_routes_that_reach_the_kernel(built_cpu, monkeypatch):
    """Through `search_batch` with a stand-in kernel: a staged "codes"
    batch calls it once, with the batch's Tq; "cells", an RQ index and the
    exact route never do."""
    index, queries = built_cpu
    calls, fake = _search_calls(monkeypatch)
    fake.eager = lambda s_t, qmask, ids, td: torch.zeros(ids.shape)
    codes = SearchParameters(approx_score="codes", **STAGED)
    assert len(search_batch(index, queries, codes)) == len(queries)
    (call,) = calls
    assert call["s_t"].shape == (len(queries), index.num_centroids, 32)
    for params in (SearchParameters(approx_score="cells", **STAGED),
                   SearchParameters(top_k=10, mode="exact")):
        search_batch(index, queries, params)
    search_batch(with_rq(index), queries, codes)
    assert len(calls) == 1


def test_served_sources_list_the_stage3b_kernel(monkeypatch):
    """The image's build step and a server's start-up (`load_kernels`)
    build and load approx_codes.cu, so no staged request waits for nvcc."""
    loaded = []
    monkeypatch.setattr(mk, "build_library", lambda src: src)
    for owner, name in ((mk, "_library"), (mk, "_library_int8")):
        monkeypatch.setattr(owner, name, lambda: None)
    monkeypatch.setattr("nextplaid_tpu_torch.ops.union_grid._library", lambda: None)
    monkeypatch.setattr(A, "_library", lambda: loaded.append("approx_codes"))
    assert A.SOURCE in mk.SERVED_SOURCES and mk.build_served()["approx_codes"] == A.SOURCE
    mk.load_kernels()
    assert loaded == ["approx_codes"]


@pytest.mark.parametrize("fault", [None, "off by 1e-4", "masked not zero", "no launch",
                                   "last token skipped"])
def test_chip_smoke_approx_codes_check_catches_what_it_holds(fault, built_cpu, monkeypatch):
    """chip_smoke.py's `approx_codes_check` passes the eager loop's scores
    and refuses a gap past its tolerance, a masked score not zero, a stage
    that did not launch, and a kernel that skips each doc's last token; the
    kernel stands in as the eager loop with the fault planted."""
    index, queries = built_cpu
    q_arr, q_mask = S._pad_queries(queries[:4] + [queries[0][:0]], index.dim)
    q, m = torch.from_numpy(q_arr), torch.from_numpy(q_mask)
    shapes = S.PipelineShapes.derive(index, SearchParameters(approx_score="codes", **STAGED),
                                     q.shape[0], q.shape[1])
    eager = S._approx_codes_scores_eager

    def fake(s_t, qmask, ids, doclens, doc_offsets, codes, num_documents, td):
        if fault != "no launch":
            A.approx_codes.launches += 1
        idx = index
        if fault == "last token skipped":
            idx = dataclasses.replace(index, doclens=torch.clamp(index.doclens - 1, min=0))
        out = eager(idx, s_t.transpose(1, 2).double(), qmask, ids, shapes)
        if fault == "off by 1e-4":
            out[0, 0] += 1e-4
        elif fault == "masked not zero":
            out[-1, 0] = 1e-30  # the last query has no live token
        return out

    fake.launches = 0
    monkeypatch.setattr(A, "supported", lambda device: True)
    monkeypatch.setattr(A, "approx_codes", fake)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, reps: (fn(), 1.0)[1])
    if fault is None:
        out = chip_smoke.approx_codes_check(index, q, m, shapes, "test")
        assert out["max_abs_err"] == out["max_rel_err"] == 0 and out["fault_gap"] > 0
        assert out["ms"] == out["stage_ms"] == out["plain_ms"] == 1.0
        assert out["shape"] == [5, shapes.prune_pool, index.num_centroids, 32]
        assert 0 < out["bound_ms"] and out["live_tokens"] > 0
    else:
        with pytest.raises(AssertionError):
            chip_smoke.approx_codes_check(index, q, m, shapes, "test")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stage-3b kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tq", TQS)
@pytest.mark.parametrize("id_dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("td", [24, 37])
def test_kernel_matches_eager_scores(cuda, tq, id_dtype, td):
    index, s_masked, qmask, ids, shapes = stage3b_case(tq + td, tq, cuda, td=td)
    ids = ids.to(id_dtype)
    before = A.approx_codes.launches
    got = S._approx_codes_scores(index, s_masked, qmask, ids, shapes)
    torch.cuda.synchronize()
    assert A.approx_codes.launches == before + 1
    want = S._approx_codes_scores_eager(index, s_masked.double(), qmask, ids.long(), shapes)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    zeros = want == 0
    dead = (ids >= index.num_documents) | (ids == 3)
    assert zeros[2].all() and zeros[dead].all()
    assert torch.equal(got[zeros], want[zeros])
    gap = float((got - want).abs().max())
    print(f"approx_codes Tq {tq} td {td} {id_dtype}: max abs {gap:.3g}, "
          f"equal share {float((got == want).float().mean()):.4f}")


@pytest.fixture(scope="module")
def built_cuda(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stage-3b kernel has no CPU mode")
    cuda = torch.device("cuda")
    docs, queries = _corpus(np.random.default_rng(0), n_docs=300, n_queries=16, dim=128)
    path = str(tmp_path_factory.mktemp("approx_codes_cuda") / "idx")
    create_index(docs, path, IndexConfig(nbits=2, seed=42), device=cuda)
    return DeviceIndex.load(path, device=cuda), queries


def _keep_cut_ties(seen, nd_live):
    """The docs whose stage-3b score lies within TIE of a query's keep cut
    where more docs than the cut keeps lie that close; every query is scored
    against the batch's union (candidate_scope "batch"), so the set is the
    batch's, one copy a query."""
    tied = set()
    for ids, scores, keep in seen:
        for row_ids, row in zip(ids.cpu().numpy(), scores.cpu().numpy()):
            live = row_ids < nd_live
            ranked = np.sort(row[live])[::-1]
            if len(ranked) > keep and ranked[keep] >= ranked[keep - 1] - TIE:
                near = np.abs(row - ranked[keep - 1]) <= TIE
                tied |= set(row_ids[live & near].tolist())
    return tied


@pytest.mark.cuda
def test_staged_batches_match_the_eager_loop(built_cuda, cuda, monkeypatch):
    """Staged "codes" batches through the kernel return the eager lowering's
    answers up to ties at the prune cuts, with one launch a batch; the
    exact, RQ and "cells" routes launch none."""
    index, queries = built_cuda
    params = SearchParameters(approx_score="codes", **STAGED)
    seen = []
    route = S._approx_codes_scores

    def recording(index_, s_masked, qmask, ids, shapes):
        out = route(index_, s_masked, qmask, ids, shapes)
        seen.append((ids, out, shapes.prune_keep))
        return out

    monkeypatch.setattr(S, "_approx_codes_scores", recording)
    before = A.approx_codes.launches
    new = [search_batch(index, queries, params) for _ in range(3)]
    torch.cuda.synchronize()
    assert A.approx_codes.launches == before + 3 and len(seen) == 3
    tied = _keep_cut_ties(seen, index.num_documents)
    monkeypatch.setattr(S, "_approx_codes_scores", S._approx_codes_scores_eager)
    old = search_batch(index, queries, params)
    for res in new:
        _assert_same_topk_but_cut_ties(res, old, [tied] * len(queries))
    monkeypatch.setattr(S, "_approx_codes_scores", route)
    search_batch(index, queries, SearchParameters(approx_score="cells", **STAGED))
    search_batch(with_rq(index), queries, params)
    search_batch(index.with_token_grid(dtype="bf16"), queries, SearchParameters(top_k=10))
    torch.cuda.synchronize()
    assert A.approx_codes.launches == before + 3
