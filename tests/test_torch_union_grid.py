"""The staged route's union grid: the CUDA kernel (csrc/union_grid.cu,
`ops.union_grid`) against the eager loop it replaces on a card
(`index.search._build_union_grid_eager`), and the eager loop kept as it is
on the CPU.

The kernel computes the eager chain's f32 arithmetic and rounds once to
bf16; only the order of a token's sum of squares differs, so its norm may
differ by an f32 ulp and an element by one bf16 ulp. Zero rows, zero
tokens and doclens are exact. The card tests run on an H100 with
`python -m pytest --noconftest -m cuda -rP tests/test_torch_union_grid.py`
(`-rP` prints the bit-identical shares).
"""

from __future__ import annotations

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
from nextplaid_tpu_torch.ops import union_grid as U

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (its union grid check; imports no JAX)

STAGED = dict(top_k=10, mode="staged", kernel="auto", n_ivf_probe=4, n_full_scores=64)
SCORE_ERR = 0.002  # the staged cell's score_err_mean limit
TIE = 1e-2  # a doc may swap in or out of a top-10 only this close to the cut


def synthetic_index(seed, nbits, dim, td, device):
    """An index's decompression tensors from a seed: 150 docs in 160 padded
    rows; doc 3 empty, doc 4 exactly td tokens, doc 5 longer than td."""
    rng = np.random.default_rng(seed)
    num_documents, nd_pad, k = 150, 160, 64
    lens = rng.integers(1, td + 1, nd_pad).astype(np.int32)
    lens[3], lens[4], lens[5] = 0, td, td + 5
    lens[num_documents:] = 0
    offsets = np.zeros(nd_pad + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    ntok = int(offsets[-1])

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    return DeviceIndex(
        centroids=t(rng.standard_normal((k, dim)) / np.sqrt(dim), torch.float32),
        codes=t(rng.integers(0, k, ntok), torch.int32),
        residuals=t(rng.integers(0, 256, (ntok, dim * nbits // 8)), torch.uint8),
        doc_offsets=t(offsets, torch.int32),
        doclens=t(lens, torch.int32),
        ivf_offsets=torch.zeros(k + 1, dtype=torch.int32, device=device),
        ivf_doc_ids=torch.zeros(0, dtype=torch.int32, device=device),
        bucket_cutoffs=t(np.zeros((1 << nbits) - 1), torch.float32),
        bucket_weights=t(np.sort(rng.standard_normal(1 << nbits)) * 0.05, torch.float32),
        avg_residual=torch.zeros(dim, device=device),
        n_docs=num_documents,
        n_emb=int(lens.sum()),
        nbits=nbits,
        max_doclen=int(lens.max()),
    )


def union_of(seed, index, cmax, dtype):
    """`cmax` sorted ids: stored docs (the empty, the full and the long one
    among them), padded rows past num_documents, ids past the padded rows,
    and the pipeline's sentinel (the last padded row) filling the tail."""
    rng = np.random.default_rng(seed + 1)
    nd, nd_pad = index.num_documents, index.num_docs_padded
    picked = rng.choice(nd, cmax - 12, replace=False)
    ids = np.concatenate([picked, [3, 4, 5, nd, nd + 2, nd_pad, nd_pad + 7]])
    ids = np.unique(ids)
    ids = np.concatenate([ids, np.full(cmax - ids.shape[0], nd_pad - 1)])
    return torch.from_numpy(ids).to(device=index.device, dtype=dtype)


def _shapes(td):
    return types.SimpleNamespace(doc_token_cap=td)


def test_supported_takes_cuda_indexes_of_the_codecs_widths():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert U.supported(cuda, 2, 128) and U.supported(cuda, 8, 48) and U.supported(cuda, 1, 256)
    assert not U.supported(cpu, 2, 128)
    assert not U.supported(cuda, 3, 128)
    assert not U.supported(cuda, 2, 40) and not U.supported(cuda, 2, 512)


def test_kernel_refuses_cpu_tensors():
    index = synthetic_index(0, 2, 32, 16, "cpu")
    ids = union_of(0, index, 40, torch.int64)
    before = U.union_grid.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        U.union_grid(ids, index.doclens, index.doc_offsets, index.codes, index.residuals,
                     index.centroids, index.bucket_weights, index.nbits,
                     index.num_documents, 16, 64, 16)
    assert U.union_grid.launches == before


@pytest.mark.parametrize("nbits", [1, 2, 4, 8])
@pytest.mark.parametrize("dim,td", [(32, 24), (48, 13)])
def test_cpu_build_takes_the_eager_loop(nbits, dim, td, monkeypatch):
    """On the CPU `_build_union_grid` is the eager loop, bit for bit, and
    never reaches the kernel's wrapper."""
    monkeypatch.setattr(S, "UNION_BUILD_TILE", 32)  # several tiles
    index = synthetic_index(nbits + dim, nbits, dim, td, "cpu")
    ids = union_of(nbits + dim, index, 77, torch.int64)
    before = U.union_grid.launches
    grid, lens = S._build_union_grid(index, ids, _shapes(td))
    want_grid, want_lens = S._build_union_grid_eager(index, ids, _shapes(td))
    assert U.union_grid.launches == before
    assert grid.shape == (128, S._round_up(td, 8), dim) and grid.dtype == torch.bfloat16
    assert torch.equal(grid.view(torch.int16), want_grid.view(torch.int16))
    assert torch.equal(lens, want_lens)
    assert torch.count_nonzero(grid[77:]) == 0 and torch.count_nonzero(lens[77:]) == 0


def test_supported_indexes_route_to_the_kernel(monkeypatch):
    """Where `supported` holds, `_build_union_grid` hands the index's tensors
    and the grid's shape to `union_grid`, and returns what it returns."""
    index = synthetic_index(1, 2, 32, 16, "cpu")
    ids = union_of(1, index, 70, torch.int64)
    calls = []

    def fake(*args, rows, td_k):
        calls.append((args, rows, td_k))
        return "grid", "doclens"

    monkeypatch.setattr(U, "supported", lambda device, nbits, dim: True)
    monkeypatch.setattr(U, "union_grid", fake)
    assert S._build_union_grid(index, ids, _shapes(13)) == ("grid", "doclens")
    ((args, rows, td_k),) = calls
    assert (rows, td_k) == (128, 16)
    assert args[0] is ids and args[7:] == (2, index.num_documents, 13)
    for got, name in zip(args[1:7], ("doclens", "doc_offsets", "codes", "residuals",
                                      "centroids", "bucket_weights")):
        assert got is getattr(index, name)


def test_served_build_and_start_up_take_the_union_grid(monkeypatch):
    """The image's build step (`build_served`) compiles union_grid.cu beside
    both MaxSim kernels and stage 3b's, and a server's start-up
    (`load_kernels`) loads its library, so no staged request waits for
    nvcc."""
    from nextplaid_tpu_torch.ops import approx_codes as A
    from nextplaid_tpu_torch.ops import maxsim_kernel as mk

    built, loaded = [], []
    monkeypatch.setattr(mk, "build_library", lambda src: built.append(src.name) or src)
    for owner, name in ((mk, "_library"), (mk, "_library_int8"), (U, "_library"),
                        (A, "_library")):
        monkeypatch.setattr(owner, name, lambda n=f"{owner.__name__}.{name}": loaded.append(n))
    assert set(mk.build_served()) == {"maxsim_bf16", "maxsim_int8", "union_grid", "approx_codes"}
    assert sorted(built) == ["approx_codes.cu", "maxsim_bf16.cu", "maxsim_int8.cu",
                             "union_grid.cu"]
    assert U.SOURCE in mk.SERVED_SOURCES
    built.clear()
    mk.load_kernels()
    assert len(built) == 4
    assert loaded == ["nextplaid_tpu_torch.ops.maxsim_kernel._library",
                      "nextplaid_tpu_torch.ops.maxsim_kernel._library_int8",
                      "nextplaid_tpu_torch.ops.union_grid._library",
                      "nextplaid_tpu_torch.ops.approx_codes._library"]


@pytest.mark.parametrize("fault", [None, "one ulp", "two ulps", "dead slot", "doclen", "no launch"])
def test_chip_smoke_union_check_catches_what_it_holds(fault, monkeypatch):
    """chip_smoke.py's `union_grid_check` passes a grid within one bf16 ulp
    of the eager loop's and refuses a larger gap, a nonzero dead slot, a
    changed doclen and a build that did not launch; the kernel stands in as
    the eager loop with the fault planted, counting its launches."""
    td = 24
    index = synthetic_index(5, 2, 32, td, "cpu")
    ids = union_of(5, index, 77, torch.int64)

    def fake(union_ids, *args, rows, td_k):
        if fault != "no launch":
            U.union_grid.launches += 1
        grid, lens = S._build_union_grid_eager(index, union_ids, _shapes(td))
        if fault in ("one ulp", "two ulps"):
            row = int(torch.nonzero(lens)[0])  # a live doc's first token
            grid.view(torch.int16)[row, 0, 0] += 1 if fault == "one ulp" else 2
        elif fault == "dead slot":
            grid[-1, 0, 0] = 1.0
        elif fault == "doclen":
            lens[0] += 1
        return grid, lens

    fake.launches = U.union_grid.launches
    monkeypatch.setattr(U, "supported", lambda device, nbits, dim: True)
    monkeypatch.setattr(U, "union_grid", fake)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, reps: (fn(), 1.0)[1])
    if fault in (None, "one ulp"):
        out = chip_smoke.union_grid_check(index, ids, _shapes(td), "test")
        assert out["max_ulp"] == (fault is not None)
        assert out["shape"] == [128, td, 32] and out["ms"] == out["plain_ms"] == 1.0
        assert out["live_tokens"] == int(torch.clamp(S._union_doclens(index, ids), max=td).sum())
        assert 0 < out["live_bound_ms"] < out["bound_ms"]
        assert U.union_grid.launches == fake.launches
    else:
        with pytest.raises(AssertionError):
            chip_smoke.union_grid_check(index, ids, _shapes(td), "test")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the union grid kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [1, 2, 4, 8])
@pytest.mark.parametrize("dim,td", [(128, 224), (48, 37), (256, 20)])
@pytest.mark.parametrize("id_dtype", [torch.int64, torch.int32])
def test_kernel_matches_eager_grid(cuda, nbits, dim, td, id_dtype):
    index = synthetic_index(nbits * dim + td, nbits, dim, td, cuda)
    cmax = 77  # rows past it: the grid has 128
    ids = union_of(nbits * dim, index, cmax, id_dtype)
    before = U.union_grid.launches
    grid, lens = S._build_union_grid(index, ids, _shapes(td))
    torch.cuda.synchronize()
    assert U.union_grid.launches == before + 1
    want_grid, want_lens = S._build_union_grid_eager(index, ids, _shapes(td))
    assert grid.shape == want_grid.shape and grid.dtype == torch.bfloat16
    assert torch.equal(lens, want_lens)
    assert torch.equal(lens[:cmax], S._union_doclens(index, ids))
    t_ar = torch.arange(grid.shape[1], device=cuda)
    live = t_ar[None, :] < torch.clamp(lens, max=td)[:, None]  # [rows, td_k]
    assert torch.count_nonzero(grid[~live]) == 0
    got = grid[live].view(torch.int16).int()
    want = want_grid[live].view(torch.int16).int()
    ulps = (got - want).abs()
    same = float((ulps == 0).float().mean())
    print(f"union_grid nbits {nbits} d {dim} td {td} {id_dtype}: {got.numel()} live "
          f"elements, bit-identical share {same:.6f}, max ulp {int(ulps.max())}")
    assert int(ulps.max()) <= 1
    assert same >= 0.999


@pytest.fixture(scope="module")
def built_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the union grid kernel has no CPU mode")
    rng = np.random.default_rng(0)
    dim = 128
    topics = rng.standard_normal((16, dim))
    topics /= np.linalg.norm(topics, axis=1, keepdims=True)

    def sample(n):
        x = topics[rng.integers(0, 16, n)] + 0.15 * rng.standard_normal((n, dim))
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)

    docs = [sample(int(n)) for n in rng.integers(8, 60, 300)]
    queries = [sample(int(n)) for n in rng.integers(5, 33, 16)]
    return docs, queries


def _check_same_answers(new, old):
    errs = []
    for a, b in zip(new, old):
        assert a.query_id == b.query_id
        errs.extend(abs(x - y) for x, y in zip(a.scores, b.scores))
        cut = min(b.scores[-1], a.scores[-1])
        for pid, score in zip(a.passage_ids, a.scores):
            if pid not in b.passage_ids:
                assert score - cut <= TIE, (a.query_id, pid)
        for pid, score in zip(b.passage_ids, b.scores):
            if pid not in a.passage_ids:
                assert score - cut <= TIE, (b.query_id, pid)
    assert float(np.mean(errs)) < SCORE_ERR


@pytest.mark.cuda
def test_staged_batches_match_the_eager_grid(built_cuda, cuda, tmp_path, monkeypatch):
    """A staged batch through the kernel returns the eager grid's answers;
    the kernel launches once a staged batch and never on the exact route."""
    docs, queries = built_cuda
    path = str(tmp_path / "idx")
    create_index(docs, path, IndexConfig(nbits=2, seed=42), device=cuda)
    index = DeviceIndex.load(path, device=cuda)
    params = SearchParameters(**STAGED)
    before = U.union_grid.launches
    new = [search_batch(index, queries, params) for _ in range(3)]
    assert U.union_grid.launches == before + 3
    with monkeypatch.context() as m:
        m.setattr(S, "_build_union_grid", S._build_union_grid_eager)
        old = search_batch(index, queries, params)
    assert U.union_grid.launches == before + 3
    for res in new:
        _check_same_answers(res, old)
    pinned = index.with_token_grid(dtype="bf16")
    exact = search_batch(pinned, queries, SearchParameters(top_k=10, kernel="auto"))
    assert len(exact) == len(queries)
    assert U.union_grid.launches == before + 3
