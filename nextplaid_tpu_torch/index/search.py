"""Search entry points: exhaustive (exact) routes.

PyTorch counterpart of the host entry points of `nextplaid_tpu.index.search`
(next-plaid `search_many_mmap`, src/search.rs:643). A batch is scored
exhaustively: by the fused MaxSim kernel when a bf16 token grid is pinned on
a CUDA device (or when `kernel="pallas"` forces it), else by the tiled scan
of `index.exact`. The JAX package's staged PLAID pipeline is not ported
yet; a route into it raises NotImplementedError.

PyTorch runs eagerly, so batches need no padding to compile-friendly
shapes: Q is the number of queries and Tq their longest length rounded up
to 32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from nextplaid_tpu_torch.index.config import SearchParameters, resolve_target_recall
from nextplaid_tpu_torch.index.container import DeviceIndex
from nextplaid_tpu_torch.index.exact import default_doc_tile, exact_search_pipeline

_STAGED_DEFERRED = (
    "the staged PLAID pipeline is not ported yet (ROADMAP.md, staged "
    "search slice); use mode='exact' or pin a token grid"
)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class QueryResult:
    """Mirror of next-plaid's `QueryResult` (src/search.rs:72-80)."""

    query_id: int
    passage_ids: List[int]
    scores: List[float]


def _pad_queries(
    queries: Sequence[np.ndarray], dim: int, tq_bucket: int = 32
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack queries into a zero-filled [Q, Tq, dim] f32 buffer and its [Q, Tq]
    mask. Padded token rows are exactly zero: the kernel route relies on it."""
    max_len = max((int(np.asarray(q).shape[0]) for q in queries), default=1)
    tq = max(_round_up(max_len, tq_bucket), tq_bucket)
    q_arr = np.zeros((len(queries), tq, dim), np.float32)
    mask = np.zeros((len(queries), tq), bool)
    for i, q in enumerate(queries):
        q = np.asarray(q, np.float32)
        q_arr[i, : q.shape[0]] = q
        mask[i, : q.shape[0]] = True
    return q_arr, mask


class PendingSearch:
    """A search batch enqueued on the device but not yet copied back.

    CUDA work is asynchronous: the ids and scores tensors exist before the
    device has computed them. Holding them here lets a caller enqueue the
    next batch before reading this one; `result()` copies them to the host
    (which waits for the device) and builds the QueryResults.
    """

    __slots__ = ("_n", "_ids", "_scores")

    def __init__(
        self, n: int, ids: Optional[torch.Tensor], scores: Optional[torch.Tensor]
    ):
        self._n = n
        self._ids = ids
        self._scores = scores

    def result(self) -> List[QueryResult]:
        n = self._n
        if n == 0:
            return []
        ids = self._ids[:n].cpu().numpy()
        scores = self._scores[:n].cpu().numpy()
        results = []
        for i in range(n):
            valid = ids[i] >= 0
            results.append(
                QueryResult(
                    query_id=i,
                    passage_ids=[int(x) for x in ids[i][valid]],
                    scores=[float(s) for s in scores[i][valid]],
                )
            )
        return results


def search_batch_async(
    index: DeviceIndex,
    queries: Sequence[np.ndarray],
    params: Optional[SearchParameters] = None,
    subset: Optional[Sequence[int]] = None,
) -> PendingSearch:
    """Enqueue a search batch without waiting for the device; call
    `.result()` on the returned PendingSearch to read it."""
    params = params or SearchParameters()
    if params.target_recall is not None:
        params = resolve_target_recall(params)
    if not queries:
        return PendingSearch(0, None, None)
    n = len(queries)
    kernel_eligible = index.has_grid and (
        params.kernel == "pallas"
        or (params.kernel == "auto" and index.device.type == "cuda")
    )
    exact_eligible = params.mode == "exact" or (
        params.mode == "auto"
        and (
            index.has_grid
            or index.num_embeddings <= params.exact_max_embeddings
        )
    )
    if not exact_eligible:
        raise NotImplementedError(f"mode={params.mode!r}: {_STAGED_DEFERRED}")

    q_arr, q_mask = _pad_queries(queries, index.dim)
    subset_t = None
    if subset is not None:
        mask = np.zeros(index.num_docs_padded, bool)
        sids = np.asarray(list(subset), np.int64)
        sids = sids[(sids >= 0) & (sids < index.num_documents)]
        mask[sids] = True
        subset_t = torch.from_numpy(mask).to(index.device)

    q_t = torch.from_numpy(q_arr)
    # Copy queries to the device in bf16 when every consumer rounds them to
    # bf16 anyway (the bf16 grid, or the scan at default precision); the
    # "highest" scan (the f32 oracle) keeps f32.
    if params.stage1_precision != "highest":
        q_t = q_t.to(torch.bfloat16)
    q_t = q_t.to(index.device)

    ids, scores = exact_search_pipeline(
        index,
        q_t,
        torch.from_numpy(q_mask).to(index.device),
        subset_t,
        top_k=min(params.top_k, max(index.num_docs_padded - 1, 1)),
        doc_tile=default_doc_tile(n, q_arr.shape[1], index.token_axis()),
        precision=params.stage1_precision,
        use_kernel=kernel_eligible,
    )
    return PendingSearch(n, ids, scores)


def search_batch(
    index: DeviceIndex,
    queries: Sequence[np.ndarray],
    params: Optional[SearchParameters] = None,
    subset: Optional[Sequence[int]] = None,
) -> List[QueryResult]:
    """Search a batch of queries and wait for the results."""
    return search_batch_async(index, queries, params, subset).result()


def search_one(
    index: DeviceIndex,
    query: np.ndarray,
    params: Optional[SearchParameters] = None,
    subset: Optional[Sequence[int]] = None,
) -> QueryResult:
    """Single-query convenience wrapper (next-plaid `search_one_mmap`)."""
    return search_batch(index, [query], params, subset)[0]
