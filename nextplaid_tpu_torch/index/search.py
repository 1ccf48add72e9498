"""Search entry points: exhaustive (exact) routes and the staged PLAID
pipeline.

PyTorch counterpart of `nextplaid_tpu.index.search` (next-plaid
`search_many_mmap`, src/search.rs:643, and its per-query pipeline,
src/search.rs:327-516).

Exact routes. A batch is scored exhaustively by the fused MaxSim kernels when
a token grid (bf16 or int8, single or bucketed) is pinned on a CUDA device
(or when `kernel="pallas"` forces it; bucketed grids always take the
kernels), else by the tiled scan of `index.exact`. On a grid-only int8 index
the kernel stage returns top-R candidates that the refinement rerank
re-scores exactly.

Staged route (`mode="staged"`, or `"auto"` on an unpinned index above
`exact_max_embeddings`), function for function the JAX package's pipeline:

  stage 1  query x centroid scores      one [Q*Tq, K] matmul for the batch
  stage 2  per-token top-nprobe cells   `_select_cells` (+ centroid-score
                                        threshold), merged per query and
                                        ordered by weight (`_dedup_cells`);
                                        on an RQ index both stages run over
                                        the factored codebook instead
                                        (`_select_cells_rq`: two small
                                        matmuls and the pair top-k), with
                                        the threshold applied in the merge
  stage 3  IVF candidate generation +   `_prune_candidates`: the selected
           weighted approximate prune   cells' posting lists as ONE flat
                                        [Q, B] stream of (doc id, cell
                                        weight), per-doc segment sums, the
                                        top `prune_pool` docs per query
  stage 3b reference approximate score  `_approx_codes_scores`
           (approx_score="codes")       (search.rs:448-457) re-ranks the pool
                                        down to `prune_keep`
  stage 4  union + shared exact scoring `_exact_on_candidates`: the batch's
                                        survivors are decompressed ONCE, into
                                        a transient bf16 grid scored by the
                                        bf16 MaxSim kernel
                                        (`_exact_on_candidates_kernel`) or
                                        tile by tile with a matmul scan
  stage 5  top-k

The JAX package shapes stage 3 around sorts and scans because of TPU scatter
and XLA compile costs; this package uses `torch.searchsorted`, stable
`torch.sort` and `scatter_reduce_` where they give the same sets: the same
overflow count, the same truncation of the weight-sorted tail beyond the
posting budget, and the same survivors, except where documents tie exactly
on their approximate score at a cut. There this package keeps the lower doc
ids (its per-doc sums are differences of an f64 running sum, so equal sets
of weights give equal sums). The JAX package's sums are differences of one
running f32 cumsum over the whole row (`nextplaid_tpu/index/search.py`,
`_prune_candidates`), so rounding, not the doc id, decides which of the
tied documents survive: the survivors can differ while their approximate
scores agree to rounding. Parity tests compare such cuts with a tie
tolerance.

PyTorch runs eagerly, so batches need no padding to compile-friendly
shapes: Q is the number of queries and Tq their longest length rounded up
to 32. A grid-only index raises SearchError on the staged route, and an
index whose IVF is stale after `append_batch` is rerouted to exhaustive
search with a warning, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from nextplaid_tpu_torch.index.config import SearchParameters, resolve_target_recall
from nextplaid_tpu_torch.index.container import DeviceIndex, decompress_docs
from nextplaid_tpu_torch.index.exact import (
    default_doc_tile,
    exact_search_pipeline,
    exact_search_split,
    masked_maxsim_tile,
    refine_own_topk_device,
    refine_topk,
)
from nextplaid_tpu_torch.ops.maxsim_kernel import MAX_DOCS, maxsim_grid_scores
from nextplaid_tpu_torch.ops.rq import pair_scores_topk
from nextplaid_tpu_torch.utils import trace
from nextplaid_tpu_torch.utils.errors import SearchError

NEG_INF = float("-inf")
# Docs decompressed per step while the transient union grid is built: the
# f32 temporaries of one step stay near 1 GB at Td 224, d 128.
UNION_BUILD_TILE = 2048


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _mark(marks: Optional[list], name: str) -> None:
    """Record a CUDA event named `name` on the current stream when the caller
    asked for stage timings (`marks` is a list); nothing otherwise."""
    if marks is not None:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((name, event))


_NO_SPAN = contextlib.nullcontext()


def _span(batch: Optional[int], name: str):
    """The tracer's span of a traced batch; nothing when the batch is not
    traced (its id is None)."""
    return _NO_SPAN if batch is None else trace.span(name, batch)


@dataclass(frozen=True)
class PipelineShapes:
    """Shapes and switches of one staged search, derived as the JAX package
    derives them.

    Fields that decide WHICH DOCUMENTS come back equal the JAX value for the
    same index, parameters and arguments: nprobe, posting_budget,
    max_candidates, top_k, doc_token_cap, threshold, prune_keep, prune_pool,
    approx_score, codes_impl, candidate_scope, overflow_policy,
    stage1_precision. `cand_tile` only tiles the stage-4 scan; the JAX
    package's `posting_chunk` (an XLA scan step) has no counterpart here,
    where the posting stream is handled whole. The caller passes the real
    query count as `num_queries` (the JAX package passes its power-of-two
    bucket); the union never exceeds queries x prune_keep, so only an
    explicit `SearchParameters.max_candidates` is felt."""

    num_queries: int  # Q
    query_tokens: int  # Tq (padded)
    nprobe: int
    posting_budget: int  # B: flat posting entries gathered per query
    max_candidates: int  # Cmax: cap on the batch-wide candidate UNION
    top_k: int
    doc_token_cap: int  # Td: max doc length (padded)
    threshold: Optional[float]
    cand_tile: int  # union candidates decompressed+scored per scan step
    nbits: int
    prune_keep: int = 1024  # M: per-query approx-score survivors
    prune_pool: int = 1024  # stage-3a pool fed to the 3b re-score (== keep
    # when approx_score == "cells"; 4x keep for "codes")
    approx_score: str = "cells"  # "cells" | "codes" (reference semantics)
    codes_impl: str = "gather"  # 3b lowering: "gather" | "mxu"
    candidate_scope: str = "batch"  # "batch" | "per_query"
    overflow_policy: str = "exact"  # on posting-budget overflow: "exact"
    # fallback (re-run exhaustively) | "prune" (lowest-weight cells dropped,
    # overflow counted and reported)
    # Precision of stage 1 and of the stage-4 scan. "highest": f32 inputs,
    # f32 sums (reference parity). "default": queries, centroids and
    # decompressed tokens rounded to bf16, their exact products summed in
    # f32 (what the JAX package's TPU passes compute); it only decides which
    # candidates reach the exact re-rank and, on the scan route, rounds the
    # scored tokens as the bf16 grid would.
    stage1_precision: str = "highest"
    # Stage 4 via the bf16 MaxSim kernel over a transient union grid (see
    # _exact_on_candidates_kernel).
    rerank_kernel: bool = False

    @classmethod
    def derive(
        cls,
        index: DeviceIndex,
        params: SearchParameters,
        num_queries: int,
        query_tokens: int,
    ) -> "PipelineShapes":
        td = max(_round_up(max(index.max_doclen, 1), 8), 8)
        ncells = query_tokens * min(params.n_ivf_probe, index.num_centroids)
        p_cap = max(index.max_posting_len, 1)
        nd = max(index.num_docs_padded - 1, 1)
        # Flat per-query posting budget: postings are gathered as ONE flat
        # [Q, B] stream (average-length driven) instead of padding every cell
        # to the max posting length. Small configurations get the exact upper
        # bound (no overflow possible); large ones are capped at 2x the
        # average with overflow counted and handled per overflow_policy.
        nnz = int(index.ivf_doc_ids.shape[0])
        avg_post = max(1, -(-nnz // max(index.num_centroids, 1)))
        b_full = ncells * p_cap
        if params.posting_budget:
            b = min(b_full, params.posting_budget)
        else:
            b = min(b_full, max(1 << 16, 2 * ncells * avg_post))
            # Skew-proof tightening: the sum of the ncells LONGEST posting
            # lists bounds the mass any probe can select, so a budget at
            # that bound can never overflow.
            bound = index.posting_mass_bound(ncells)
            if bound is not None:
                b = min(b, max(1 << 16, bound))
        b = max(_round_up(b, 128), 128)
        # Per-query approximate-prune depth: the reference's exact re-rank
        # breadth n_full_scores/4 (search.rs:468).
        keep = params.prune_keep or max(params.n_full_scores // 4, 16)
        keep = min(keep, b, max(nd, 1))
        keep = max(keep, min(params.top_k, nd), 1)
        approx = params.approx_score
        if approx == "codes":
            pool = min(4 * keep, b, max(nd, 1))
        else:
            pool = keep
        # Union cap: Q*keep is an exact upper bound of the deduped union.
        cmax = min(num_queries * keep, nd)
        if params.max_candidates:
            cmax = min(cmax, params.max_candidates)
        cmax = max(_round_up(cmax, 8), 8)
        top_k = min(params.top_k, nd)
        budget = 128 << 20
        tile_bytes = max(num_queries * query_tokens * td * 4, 1)
        cand_tile = int(np.clip(budget // tile_bytes, 8, 512))
        cand_tile = min(cand_tile, cmax)
        # Stage-4 kernel re-rank: staged search runs in the unpinned regime,
        # so device memory is free for a transient bf16 union grid, and the
        # kernel keeps the similarity blocks of the scan out of it.
        grid_bytes = _round_up(cmax, 64) * _round_up(td, 8) * index.dim * 2
        rerank_kernel = (
            params.kernel not in ("xla", "off")
            and (index.device.type == "cuda" or params.kernel == "pallas")
            and grid_bytes
            <= int(os.environ.get("NEXT_PLAID_RERANK_GRID_MB", "6144")) * (1 << 20)
        )
        return cls(
            num_queries=num_queries,
            query_tokens=query_tokens,
            nprobe=min(params.n_ivf_probe, index.num_centroids),
            posting_budget=b,
            max_candidates=cmax,
            top_k=top_k,
            doc_token_cap=td,
            threshold=params.centroid_score_threshold,
            cand_tile=cand_tile,
            nbits=index.nbits,
            prune_keep=keep,
            prune_pool=pool,
            approx_score=approx,
            codes_impl=os.environ.get("NEXT_PLAID_CODES_IMPL", "gather"),
            rerank_kernel=rerank_kernel,
            candidate_scope=params.candidate_scope,
            overflow_policy=params.overflow_policy,
            stage1_precision=params.stage1_precision,
        )


# ---------------------------------------------------------------------------
# Stage implementations
# ---------------------------------------------------------------------------


def _run_sums(
    keys_sorted: torch.Tensor, values_sorted: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-run sums over rows of key-sorted pairs. Returns (sums [Q, N] f32,
    holding each run's total at every slot of the run, last [Q, N] bool
    marking each run's last slot). Sums are differences of an f64 running
    sum, so equal sets of values give equal totals whatever precedes them."""
    q_n, n = keys_sorted.shape
    dev = keys_sorted.device
    ones = torch.ones((q_n, 1), dtype=torch.bool, device=dev)
    first = torch.cat([ones, keys_sorted[:, 1:] != keys_sorted[:, :-1]], dim=1)
    last = torch.cat([first[:, 1:], ones], dim=1)
    csum = torch.cumsum(values_sorted.double(), dim=1)
    slot = torch.arange(n, device=dev)
    run_start = torch.cummax(
        torch.where(first, slot[None, :], torch.zeros_like(slot)[None, :]), dim=1
    ).values
    base = torch.where(
        run_start > 0,
        torch.gather(csum, 1, torch.clamp(run_start - 1, min=0)),
        torch.zeros_like(csum),
    )
    return (csum - base).float(), last


def _top_by_score(
    scores: torch.Tensor, ids: torch.Tensor, n: int, sentinel: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The `n` best (score, id) pairs of each row, best first; slots without
    a finite score hold (-inf, sentinel). A stable sort on the negated
    score: ties keep their order in `ids` (ascending doc id at both cuts),
    as the JAX package's `lax.sort` does."""
    neg = torch.where(torch.isfinite(scores), -scores, torch.full_like(scores, float("inf")))
    sorted_neg, order = torch.sort(neg, dim=1, stable=True)
    vals = -sorted_neg[:, :n]
    top_ids = torch.gather(ids, 1, order[:, :n])
    return vals, torch.where(torch.isfinite(vals), top_ids, torch.full_like(top_ids, sentinel))


def _select_cells(
    scores_masked: torch.Tensor, qmask: torch.Tensor, shapes: PipelineShapes, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stages 1-2: per-token top-nprobe + threshold prune.

    Returns ([Q, Tq*nprobe] int64 cell ids with sentinel `k` for pruned
    slots, [Q, Tq*nprobe] f32 cell scores with 0 for pruned slots).
    """
    q_n = scores_masked.shape[0]
    top_vals, top_cells = torch.topk(scores_masked, shapes.nprobe, dim=-1)
    valid = qmask[:, :, None] & torch.isfinite(top_vals)
    if shapes.threshold is not None:
        # Reference semantics (search.rs:417-425): drop a selected cell when
        # its MAX score over all query tokens is below the threshold.
        cell_max = scores_masked.amax(dim=1)  # [Q, K]
        gathered_max = torch.gather(
            cell_max, 1, top_cells.reshape(q_n, -1)
        ).view_as(top_cells)
        valid = valid & (gathered_max >= shapes.threshold)
    cells = torch.where(valid, top_cells, torch.full_like(top_cells, k))
    weights = torch.where(valid, top_vals, torch.zeros_like(top_vals)).float()
    return cells.reshape(q_n, -1), weights.reshape(q_n, -1)


def _dedup_cells(
    cells: torch.Tensor,
    weights: torch.Tensor,
    k: int,
    threshold: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge repeated cells per query (a cell probed by several query tokens
    contributes the SUM of their scores to every posting-list member), then
    order by descending weight so posting-budget truncation drops the least
    promising cells first. Sentinel slots (cell == k) carry weight 0.

    `threshold` (the RQ stage-1 path only) drops merged cells whose MAX
    single-token score is below it: the reference's centroid_score_threshold
    (search.rs:417-425) taken over the tokens that selected the cell rather
    than over all tokens, since the [Q, Tq, K] score table is never built
    under RQ (the JAX package's proxy semantics)."""
    cells_s, order = torch.sort(cells, dim=1, stable=True)
    w_s = torch.gather(weights, 1, order)
    sums, last = _run_sums(cells_s, w_s)
    keep = last & (cells_s < k)
    if threshold is not None:
        # Each run's max, read back at every slot of the run.
        first = torch.ones_like(keep)
        first[:, 1:] = cells_s[:, 1:] != cells_s[:, :-1]
        run_id = torch.cumsum(first.long(), dim=1) - 1
        run_max = torch.full_like(w_s, NEG_INF).scatter_reduce_(
            1, run_id, w_s, "amax", include_self=True
        )
        keep = keep & (torch.gather(run_max, 1, run_id) >= threshold)
    merged_w = torch.where(keep, sums, torch.zeros_like(sums))
    merged_c = torch.where(keep, cells_s, torch.full_like(cells_s, k))
    # Descending weight, ties in cell order.
    order = torch.sort(-merged_w, dim=1, stable=True).indices
    return torch.gather(merged_c, 1, order), torch.gather(merged_w, 1, order)


def _select_cells_rq(
    queries: torch.Tensor, qmask: torch.Tensor, index: DeviceIndex, shapes: PipelineShapes
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stages 1-2 over the factored RQ codebook (ops/rq.py): two small
    matmuls ([Q*Tq, C] and [Q*Tq, F]) and the separable pair top-k in a
    top-a x top-b margin of max(32, 2*nprobe), instead of the [Q*Tq, K]
    table. The threshold is applied when cells are merged (`_dedup_cells`).

    Returns ([Q, Tq*nprobe] int64 cells with sentinel K, [Q, Tq*nprobe] f32
    scores with 0 for empty slots)."""
    k = index.num_centroids
    q_n, tq, d = queries.shape
    q_in, coarse, fine = queries.float(), index.rq_coarse, index.rq_fine
    if shapes.stage1_precision != "highest":
        q_in = q_in.to(torch.bfloat16).float()
        coarse = coarse.to(torch.bfloat16).float()
        fine = fine.to(torch.bfloat16).float()
    q_flat = q_in.reshape(q_n * tq, d)
    xc = (q_flat @ coarse.T).view(q_n, tq, -1)
    xf = (q_flat @ fine.T).view(q_n, tq, -1)
    margin = max(32, 2 * shapes.nprobe)
    vals, cells = pair_scores_topk(
        xc,
        xf,
        index.rq_inv_norms,
        k=shapes.nprobe,
        a=min(margin, coarse.shape[0]),
        b=min(margin, fine.shape[0]),
    )
    valid = qmask[:, :, None] & torch.isfinite(vals)
    cells = torch.where(valid, cells, torch.full_like(cells, k))
    weights = torch.where(valid, vals, torch.zeros_like(vals)).float()
    return cells.reshape(q_n, -1), weights.reshape(q_n, -1)


def _approx_codes_scores(
    index: DeviceIndex,
    s_masked: torch.Tensor,  # [Q, Tq, K] centroid scores (-inf masked rows)
    qmask: torch.Tensor,  # [Q, Tq]
    cand_ids: torch.Tensor,  # [Q, pool] doc ids (capacity sentinel for empty)
    shapes: PipelineShapes,
    queries: Optional[torch.Tensor] = None,  # [Q, Tq, d] for the "mxu" variant
) -> torch.Tensor:
    """Stage 3b: reference approximate scoring (search.rs:448-457) on the
    pooled survivors. For each candidate, gather its token codes and score
    sum_t max_{code in doc} S[q, t, code].

    Two lowerings, as in the JAX package (NEXT_PLAID_CODES_IMPL, default
    "gather"):
    - "gather": S is transposed once to [Q, K, Tq] so each candidate
      token's lookup reads one contiguous [Tq] row; exact f32 lookups.
    - "mxu": recompute the gathered values: since S[q,t,c] = q_t . centroid_c,
      the per-candidate score is MaxSim(query, centroids[codes(doc)]), a
      batched matmul over bf16-rounded centroids and queries with f32 sums.
    """
    q_n, pool = cand_ids.shape
    td = shapes.doc_token_cap
    tq = s_masked.shape[1]
    nd_pad = index.num_docs_padded
    nvec_pad = index.codes.shape[0]
    dev = cand_ids.device
    t_ar = torch.arange(td, device=dev)
    impl = shapes.codes_impl

    if impl == "mxu":
        if queries is None:
            raise ValueError('codes_impl="mxu" needs the queries')
        cent = index.centroids.to(torch.bfloat16).float()
        q_bf = (
            torch.where(qmask[:, :, None], queries.float(), torch.zeros((), device=dev))
            .to(torch.bfloat16).float().transpose(1, 2)
        )  # [Q, d, Tq]
        # tile targeting ~0.5 GB centroid-vector blocks
        tile_budget = (512 << 20) // max(q_n * td * index.dim * 4, 1)
    else:
        s_t = s_masked.transpose(1, 2).contiguous()  # [Q, K, Tq]
        q_ar = torch.arange(q_n, device=dev)[:, None]
        # tile targeting ~256 MB gathered blocks
        tile_budget = (256 << 20) // max(q_n * tq * td * 4, 1)
    tile = int(np.clip(tile_budget, 1, pool))

    out = torch.empty((q_n, pool), dtype=torch.float32, device=dev)
    for s in range(0, pool, tile):
        tile_ids = cand_ids[:, s : s + tile]
        n = tile_ids.shape[1]
        safe = torch.clamp(tile_ids, 0, nd_pad - 1).long()
        offs = index.doc_offsets[safe].long()  # [Q, n]
        lens = torch.where(
            tile_ids < index.num_documents, index.doclens[safe], 0
        )
        tok_pos = torch.clamp(offs[:, :, None] + t_ar, 0, nvec_pad - 1)
        codes = index.codes[tok_pos].long().reshape(q_n, n * td)
        tok_valid = t_ar < lens[:, :, None]  # [Q, n, Td]
        if impl == "mxu":
            g = torch.bmm(cent[codes], q_bf)  # [Q, n*Td, Tq]
        else:
            g = s_t[q_ar, codes]  # contiguous [Tq] rows
        g = g.view(q_n, n, td, tq).masked_fill(~tok_valid[:, :, :, None], NEG_INF)
        per_tok = g.amax(dim=2)  # [Q, n, Tq]
        per_tok = torch.where(
            qmask[:, None, :] & torch.isfinite(per_tok), per_tok,
            torch.zeros_like(per_tok),
        )
        out[:, s : s + n] = per_tok.sum(dim=2)
    return out


def _prune_candidates(
    index: DeviceIndex,
    cells: torch.Tensor,
    weights: torch.Tensor,
    shapes: PipelineShapes,
    s_masked: Optional[torch.Tensor] = None,  # [Q, Tq, K] for stage 3b "codes"
    qmask: Optional[torch.Tensor] = None,  # [Q, Tq]
    queries: Optional[torch.Tensor] = None,  # [Q, Tq, d] for 3b's mxu variant
    marks: Optional[list] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Stage 3: flat weighted posting gathers -> per-query approximate
    prune -> batch-wide candidate union.

    Selected cells' posting lists are laid out as ONE flat [Q, B] stream
    (cell-of-slot by `searchsorted` over per-query cumulative lengths), so
    cost follows the TOTAL posting mass, not ncells x the longest list. Each
    slot carries its cell's weight (summed stage-2 scores of the query tokens
    that probed it); a sort by doc id + segment sum turns the stream into
    per-doc approximate scores, and each query keeps its top `prune_keep`
    docs.

    Cells are pre-sorted by descending weight (_dedup_cells), so when the
    posting mass exceeds the budget B the truncated tail holds the LEAST
    promising cells; the dropped count is still reported as overflow.

    Returns (union_ids [Cmax] int64, sorted, with the zero-doclen capacity
    slot (num_docs_padded - 1) as sentinel for empty slots; overflow [] =
    posting entries beyond the budget (or union entries beyond an explicit
    max_candidates); mine [Q, Cmax] bool or None).

    Scope semantics (SearchParameters.candidate_scope):
      - "batch" (default): every query is scored against the whole batch
        union exactly; `mine` is None.
      - "per_query": reference semantics: each query ranks only its own
        prune survivors.
    """
    q_n, ncells = cells.shape
    k = index.num_centroids
    nd = index.num_docs_padded - 1  # sentinel slot (doclen 0)
    nd_live = index.num_documents
    nnz_pad = index.ivf_doc_ids.shape[0]
    b = shapes.posting_budget
    keep = shapes.prune_keep
    cmax = shapes.max_candidates
    dev = cells.device

    # Cumulative lengths are int64 (torch promotes the int32 offsets' sum).
    offsets = index.ivf_offsets.long()
    safe_cells = torch.clamp(cells, max=k)
    starts = offsets[safe_cells]  # [Q, C]
    ends = offsets[torch.clamp(safe_cells + 1, max=k)]
    lens = torch.where(cells < k, ends - starts, torch.zeros_like(starts))
    cum = torch.cumsum(lens, dim=1)  # [Q, C]
    total = cum[:, -1]
    posting_overflow = torch.clamp(total - b, min=0).max()

    j = torch.arange(b, device=dev)  # [B] flat slot ids
    # Slot -> cell: the first cell whose cumulative length exceeds the slot
    # (zero-length cells cede to the next one starting at the same slot).
    cell_pos = torch.searchsorted(cum, j[None, :].expand(q_n, b).contiguous(), right=True)
    in_range = j[None, :] < torch.clamp(total, max=b)[:, None]
    cell_pos = torch.where(
        in_range, torch.clamp(cell_pos, max=ncells - 1), torch.zeros_like(cell_pos)
    )
    before = torch.where(
        cell_pos > 0,
        torch.gather(cum, 1, torch.clamp(cell_pos - 1, min=0)),
        torch.zeros_like(cell_pos),
    )
    pos = torch.gather(starts, 1, cell_pos) + (j[None, :] - before)
    pos = torch.where(in_range, torch.clamp(pos, 0, nnz_pad - 1), torch.zeros_like(pos))
    ids = index.ivf_doc_ids[pos].long()
    ids = torch.where(in_range, ids, torch.full_like(ids, nd))
    w = torch.where(
        in_range, torch.gather(weights, 1, cell_pos), torch.zeros((), device=dev)
    )
    del cell_pos, before, pos

    # Per-doc approximate score: sort by doc id, sum the weights of each run,
    # read each run's total at its last slot.
    ids_s, order = torch.sort(ids, dim=1, stable=True)
    sums, last = _run_sums(ids_s, torch.gather(w, 1, order))
    del ids, w, order
    approx = torch.where(
        last & (ids_s < nd_live), sums, torch.full_like(sums, NEG_INF)
    )

    # Per-query prune: keep the top `pool` docs by cell-weight score.
    pool = shapes.prune_pool
    pool_vals, pool_ids = _top_by_score(approx, ids_s, pool, nd)
    del approx, sums, last, ids_s
    _mark(marks, "stage3")

    if shapes.approx_score == "codes" and s_masked is not None:
        # Stage 3b: REFERENCE approximate-score semantics on the pooled
        # survivors. Re-rank the pool, keep the top `keep`.
        code_scores = _approx_codes_scores(
            index, s_masked, qmask, pool_ids, shapes, queries=queries
        )  # [Q, pool]
        code_scores = torch.where(
            pool_ids < nd_live, code_scores, torch.full_like(code_scores, NEG_INF)
        )
        top_vals, qcand = _top_by_score(code_scores, pool_ids, keep, nd)
    else:
        top_vals = pool_vals[:, :keep]
        qcand = pool_ids[:, :keep]
    _mark(marks, "stage3b")

    # Batch union: sort-dedup the concatenated survivor lists. Q*keep is an
    # exact upper bound, so the union itself cannot overflow (cmax only
    # shrinks it when the caller caps max_candidates explicitly).
    flat, order = torch.sort(qcand.reshape(-1), stable=True)
    uniq_first = torch.cat(
        [torch.ones(1, dtype=torch.bool, device=dev), flat[1:] != flat[:-1]]
    )
    real_first = uniq_first & (flat < nd_live)
    sentinel = torch.full_like(flat, nd)
    if cmax < q_n * keep:
        # The union is truncated: keep the docs with the highest approximate
        # score across queries (ties towards the lower doc id), and count
        # the truncation as overflow.
        vals_by_id = top_vals.reshape(-1)[order]
        run_id = torch.cumsum(uniq_first.long(), dim=0) - 1
        best = torch.full_like(vals_by_id, NEG_INF).scatter_reduce_(
            0, run_id, vals_by_id, "amax", include_self=True
        )
        best_per_first = torch.where(
            real_first, best[run_id], torch.full_like(best, NEG_INF)
        )
        _, union_ids = _top_by_score(best_per_first[None], flat[None], cmax, nd)
        union_ids = torch.sort(union_ids[0]).values
        union_overflow = torch.clamp(real_first.sum() - cmax, min=0)
        posting_overflow = torch.maximum(posting_overflow, union_overflow)
    else:
        union_ids = torch.sort(torch.where(real_first, flat, sentinel)).values[:cmax]
    if union_ids.shape[0] < cmax:  # Q*keep below the cap's round-up to 8
        union_ids = torch.cat([union_ids, sentinel[: cmax - union_ids.shape[0]]])

    mine = None
    if shapes.candidate_scope == "per_query":
        rows_sorted = torch.sort(qcand, dim=1).values  # [Q, keep]
        probe = union_ids[None, :].expand(q_n, cmax).contiguous()
        lo = torch.searchsorted(rows_sorted, probe, right=False)
        hi = torch.searchsorted(rows_sorted, probe, right=True)
        mine = hi > lo  # [Q, Cmax]
    return union_ids, posting_overflow, mine


def _union_doclens(index: DeviceIndex, union_ids: torch.Tensor) -> torch.Tensor:
    """Lengths [n] int32 of the union's docs; 0 for sentinel ids."""
    safe = torch.clamp(union_ids, 0, index.num_docs_padded - 1)
    return torch.where(
        union_ids < index.num_documents, index.doclens[safe], 0
    ).to(torch.int32)


def _build_union_grid(
    index: DeviceIndex, union_ids: torch.Tensor, shapes: PipelineShapes
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decompress the union ONCE into a transient bf16 token grid
    [round_up(Cmax, 64), round_up(Td, 8), d] with its doclens [rows] int32
    (0 for sentinel ids and the rows past Cmax; token rows at or beyond a
    doc's length are zero).

    The grid is a fresh `torch.empty` per batch: the caching allocator hands
    the same block back for the same shape, and batches on one stream run
    in order, so in-flight batches share it safely."""
    cmax = union_ids.shape[0]
    td = shapes.doc_token_cap
    td_k = _round_up(td, 8)
    nd_k = max(_round_up(cmax, 64), 64)
    dev = union_ids.device
    grid = torch.empty((nd_k, td_k, index.dim), dtype=torch.bfloat16, device=dev)
    for s in range(0, cmax, UNION_BUILD_TILE):
        ids = union_ids[s : s + UNION_BUILD_TILE]
        grid[s : s + ids.shape[0], :td] = decompress_docs(index, ids, td).to(
            torch.bfloat16
        )
    grid[cmax:] = 0
    if td_k > td:
        grid[:, td:] = 0
    doclens = torch.zeros(nd_k, dtype=torch.int32, device=dev)
    doclens[:cmax] = _union_doclens(index, union_ids)
    return grid, doclens


def _exact_on_candidates_kernel(
    index: DeviceIndex,
    queries: torch.Tensor,
    qmask: torch.Tensor,
    union_ids: torch.Tensor,
    shapes: PipelineShapes,
    marks: Optional[list] = None,
    counts: Optional[dict] = None,
) -> torch.Tensor:
    """Stage 4 via the bf16 MaxSim kernel: score the transient union grid
    exactly like the pinned-grid exhaustive path.

    The scan variant below materializes a [Q, tile, Tq, Td] f32 similarity
    block per tile; the kernel keeps those blocks on chip, so stage 4 pays
    one grid write (3.8 GB bf16 at Cmax 65,536, Td 224, d 128) plus the
    products. Sentinel rows have doclen 0, which the kernel masks by length:
    they score 0 whatever their rows hold.

    `counts`, when a dict, receives the union grid's token slots (an int)
    and its live tokens (a device scalar, read back with the batch's
    results)."""
    q_n, tq, d = queries.shape
    cmax = union_ids.shape[0]
    grid, doclens = _build_union_grid(index, union_ids, shapes)
    if counts is not None:
        counts.update({
            "staged.union_token_slots": grid.shape[0] * shapes.doc_token_cap,
            "staged.union_live_tokens": doclens.sum(),
        })
    qflat = (
        torch.where(
            qmask[:, :, None], queries.float(), torch.zeros((), device=grid.device)
        )
        .reshape(q_n * tq, d)
        .to(torch.bfloat16)
    )
    _mark(marks, "stage4_grid")
    # The kernel's launch grid holds MAX_DOCS rows: larger unions go in
    # row chunks (each a contiguous, aligned slice of the grid).
    chunk = (MAX_DOCS // 64) * 64
    parts = [
        maxsim_grid_scores(qflat, grid[s : s + chunk], doclens[s : s + chunk], tq=tq)
        for s in range(0, grid.shape[0], chunk)
    ]
    scores = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    _mark(marks, "stage4_kernel")
    return scores[:, :cmax]


def _exact_on_candidates(
    index: DeviceIndex,
    queries: torch.Tensor,
    qmask: torch.Tensor,
    union_ids: torch.Tensor,
    shapes: PipelineShapes,
    marks: Optional[list] = None,
    counts: Optional[dict] = None,
) -> torch.Tensor:
    """Stage 4: decompress each union candidate ONCE, exact MaxSim against
    the whole query batch. Returns scores [Q, Cmax] (0 for sentinel slots)."""
    if shapes.rerank_kernel:
        return _exact_on_candidates_kernel(
            index, queries, qmask, union_ids, shapes, marks, counts
        )
    q_n, tq, d = queries.shape
    cmax = union_ids.shape[0]
    td = shapes.doc_token_cap
    q_in = queries.float()
    if shapes.stage1_precision != "highest":
        q_in = q_in.to(torch.bfloat16).float()
    q_flat = q_in.reshape(q_n * tq, d)
    out = torch.empty((q_n, cmax), dtype=torch.float32, device=union_ids.device)
    for s in range(0, cmax, shapes.cand_tile):
        ids = union_ids[s : s + shapes.cand_tile]
        emb = decompress_docs(index, ids, td)  # shared across all queries
        if shapes.stage1_precision != "highest":
            emb = emb.to(torch.bfloat16).float()
        out[:, s : s + ids.shape[0]] = masked_maxsim_tile(
            q_flat, qmask, emb, _union_doclens(index, ids)
        )
    _mark(marks, "stage4_scan")
    return out


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------


def search_pipeline(
    index: DeviceIndex,
    queries: torch.Tensor,  # [Q, Tq, d] f32 (zero-padded)
    qmask: torch.Tensor,  # [Q, Tq] bool
    subset_mask: Optional[torch.Tensor],  # [num_docs_padded] bool or None
    shapes: PipelineShapes,
    marks: Optional[list] = None,
    counts: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (doc_ids [Q, top_k] i32 with -1 invalid, scores [Q, top_k] f32,
    overflow [Q] i64). Nothing here waits for the device.

    `marks`, when a list, receives (stage name, CUDA event) pairs recorded at
    the stage boundaries, for timing a batch stage by stage. `counts`, when
    a dict, receives the stage-4 union grid's live share
    (`_exact_on_candidates_kernel`)."""
    k = index.num_centroids
    q_n, tq, d = queries.shape
    _mark(marks, "start")

    if index.rq_coarse is not None:
        # Stages 1-2 over the factored codebook, the threshold applied in
        # the merge. No [Q, Tq, K] table exists, so stage 3b's "codes"
        # scoring falls back to the cell weights, as in the JAX package.
        cells, weights = _select_cells_rq(queries, qmask, index, shapes)
        cells, weights = _dedup_cells(cells, weights, k, threshold=shapes.threshold)
        s_masked = None
    else:
        # Stage 1: batched centroid scores (a plain matmul, TF32 off).
        q_in, cent = queries.float(), index.centroids
        if shapes.stage1_precision != "highest":
            q_in = q_in.to(torch.bfloat16).float()
            cent = cent.to(torch.bfloat16).float()
        s_raw = (q_in.reshape(q_n * tq, d) @ cent.T).view(q_n, tq, k)
        s_masked = s_raw.masked_fill(~qmask[:, :, None], NEG_INF)
        del s_raw

        # Stage 2: cell selection + per-query merge of repeated cells.
        cells, weights = _select_cells(s_masked, qmask, shapes, k)
        cells, weights = _dedup_cells(cells, weights, k)
    _mark(marks, "stage12")

    # Stage 3 (+3b): weighted posting streams -> approximate prune -> union.
    union_ids, overflow, mine = _prune_candidates(
        index, cells, weights, shapes, s_masked=s_masked, qmask=qmask,
        queries=queries, marks=marks,
    )
    del s_masked
    _mark(marks, "union")

    # Stage 4: exact MaxSim on the union (decompress once per candidate).
    exact = _exact_on_candidates(
        index, queries, qmask, union_ids, shapes, marks, counts
    )
    valid = (union_ids < index.num_documents)[None, :]
    if mine is not None:
        valid = valid & mine
    if subset_mask is not None:
        valid = valid & subset_mask[
            torch.clamp(union_ids, 0, index.num_docs_padded - 1)
        ][None, :]
    exact = torch.where(valid, exact, torch.full_like(exact, NEG_INF))

    # Stage 5: final top-k.
    final_scores, final_slots = torch.topk(
        exact, min(shapes.top_k, exact.shape[1]), dim=1
    )
    final_ids = union_ids[final_slots].to(torch.int32)
    final_ids = torch.where(
        torch.isfinite(final_scores), final_ids, torch.full_like(final_ids, -1)
    )
    _mark(marks, "stage5")
    return final_ids, final_scores, overflow.expand(q_n)


# ---------------------------------------------------------------------------
# Host entry points
# ---------------------------------------------------------------------------


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


# The stage marks each device span of a traced staged batch runs between
# (the union grid exists on the kernel route alone).
_STAGE_SPANS = (
    ("staged.select_prune", "start", "union"),
    ("staged.union_grid", "union", "stage4_grid"),
)


class PendingSearch:
    """A search batch enqueued on the device but not yet copied back.

    CUDA work is asynchronous: the ids and scores tensors exist before the
    device has computed them. Holding them here lets a caller enqueue the
    next batch before reading this one; `result()` copies them to the host
    (which waits for the device), runs the union refinement rerank when the
    batch still owes one, applies the staged route's overflow fallback, and
    builds the QueryResults.

    A batch dispatched while tracing was on carries its batch id, and on
    the staged route its stage marks and union counters, which `result()`
    records once the results are back; otherwise `batch` is None and
    `result()` records nothing.
    """

    __slots__ = (
        "_index", "_queries", "_params", "_subset",
        "_n", "_ids", "_scores", "_overflow", "_shapes", "_refine_k",
        "_batch", "_marks", "_counts",
    )

    def __init__(
        self,
        index: Optional[DeviceIndex],
        queries: Sequence[np.ndarray],
        params: SearchParameters,
        subset: Optional[Sequence[int]],
        n: int,
        ids: Optional[torch.Tensor],
        scores: Optional[torch.Tensor],
        overflow: Optional[torch.Tensor] = None,
        shapes: Optional[PipelineShapes] = None,
        refine_k: int = 0,
        batch: Optional[int] = None,
        marks: Optional[list] = None,
        counts: Optional[dict] = None,
    ):
        self._index = index
        self._queries = queries
        self._params = params
        self._subset = subset
        self._n = n
        self._ids = ids
        self._scores = scores
        self._overflow = overflow
        self._shapes = shapes
        self._refine_k = refine_k
        self._batch = batch
        self._marks = marks
        self._counts = counts

    def result(self) -> List[QueryResult]:
        n = self._n
        if n == 0:
            return []
        with _span(self._batch, "search.result"):
            return self._result(n)

    def _result(self, n: int) -> List[QueryResult]:
        batch = self._batch
        with _span(batch, "search.result.wait"):
            ids = self._ids[:n].cpu().numpy()
            scores = self._scores[:n].cpu().numpy()
            counts = self._counts_back()
        if batch is not None:
            self._record(counts)
        if self._refine_k:
            with _span(batch, "search.result.refine"):
                # Grid-only refinement over the batch's candidate union (the
                # depth was too large for the per-query device rerank).
                q_arr, q_mask = _pad_queries(self._queries, self._index.dim)
                ids, scores = refine_topk(
                    self._index, q_arr, q_mask, ids, self._refine_k
                )
        with _span(batch, "search.result.build"):
            if self._shapes is not None and self._params.overflow_policy == "exact":
                overflow = int(self._overflow[:n].max().item())
                if overflow > 0:
                    logging.getLogger(__name__).warning(
                        "posting-budget overflow: up to %d posting entries "
                        "dropped (posting_budget=%d) — falling back to "
                        "exhaustive scoring for this batch; raise "
                        "SearchParameters.posting_budget or set "
                        "overflow_policy='prune' (lowest-weight cells "
                        "dropped) if this recurs",
                        overflow,
                        self._shapes.posting_budget,
                    )
                    # Dropping candidates silently biases (or empties)
                    # results; the exhaustive scan is always correct and
                    # streams in bounded tiles, so prefer slow-and-right.
                    return search_batch(
                        self._index,
                        self._queries,
                        dataclasses.replace(self._params, mode="exact"),
                        subset=self._subset,
                    )
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

    def _counts_back(self) -> dict:
        """The traced batch's counters, a device scalar copied back (after
        the results: the stream has drained)."""
        return {
            k: v.item() if torch.is_tensor(v) else v
            for k, v in (self._counts or {}).items()
        }

    def _record(self, counts: dict) -> None:
        batch = self._batch
        for name, value in counts.items():
            trace.count(name, value, batch)
        if self._marks:
            events = dict(self._marks)
            for name, a, b in _STAGE_SPANS:
                if a in events and b in events:
                    trace.device_span(name, events[a], events[b], batch)

    @property
    def overflow(self) -> Optional[torch.Tensor]:
        """Staged route: [Q] posting (or union) entries dropped by the
        budget, on the device; None on the exact routes."""
        return self._overflow

    @property
    def shapes(self) -> Optional[PipelineShapes]:
        """Staged route: the batch's PipelineShapes; None on the exact routes."""
        return self._shapes


def search_batch_async(
    index: DeviceIndex,
    queries: Sequence[np.ndarray],
    params: Optional[SearchParameters] = None,
    subset: Optional[Sequence[int]] = None,
) -> PendingSearch:
    """Enqueue a search batch without waiting for the device; call
    `.result()` on the returned PendingSearch to read it.

    While tracing is on (`utils/trace.py`) the batch gets an id, and its
    dispatch and read are recorded as `search.dispatch` and
    `search.result` with their phases; off, nothing is recorded."""
    params = params or SearchParameters()
    if params.target_recall is not None:
        params = resolve_target_recall(params)
    if not queries:
        return PendingSearch(index, queries, params, subset, 0, None, None)
    batch = trace.next_batch() if trace.active() else None
    with _span(batch, "search.dispatch"):
        return _dispatch(index, queries, params, subset, batch)


def _dispatch(
    index: DeviceIndex,
    queries: Sequence[np.ndarray],
    params: SearchParameters,
    subset: Optional[Sequence[int]],
    batch: Optional[int],
) -> PendingSearch:
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
    if index.grid_only and not exact_eligible:
        raise SearchError(
            "grid-only index serves exact search only (codes/IVF are not "
            "resident); use mode='exact'/'auto' or reload with "
            "DeviceIndex.load for staged search"
        )
    if not exact_eligible and index.ivf_stale:
        # Appends leave the staged pipeline's IVF stale (the pinned serving
        # path never reads it); exhaustive scoring is the correct, slower
        # answer until refresh_ivf.
        logging.getLogger(__name__).warning(
            "IVF is stale after device appends; routing to exhaustive "
            "search (call DeviceIndex.refresh_ivf to restore staged mode)"
        )
        exact_eligible = True

    with _span(batch, "search.dispatch.pad"):
        q_arr, q_mask = _pad_queries(queries, index.dim)
        subset_np = None
        if subset is not None:
            subset_np = np.zeros(index.num_docs_padded, bool)
            sids = np.asarray(list(subset), np.int64)
            sids = sids[(sids >= 0) & (sids < index.num_documents)]
            subset_np[sids] = True
        q_t = torch.from_numpy(q_arr)
        # Copy queries to the device in bf16 when every consumer rounds them
        # to bf16 anyway (the bf16 grid, or the scan at default precision).
        # The "highest" scan (the f32 oracle), int8 grids (quantized on the
        # device from f32) and the staged route keep f32.
        if (
            exact_eligible
            and params.stage1_precision != "highest"
            and not index.grid_is_int8
        ):
            q_t = q_t.to(torch.bfloat16)
    with _span(batch, "search.dispatch.copy"):
        subset_t = None
        if subset_np is not None:
            subset_t = torch.from_numpy(subset_np).to(index.device)
        q_t = q_t.to(index.device)
        mask_t = torch.from_numpy(q_mask).to(index.device)
    with _span(batch, "search.dispatch.route"):
        if not exact_eligible:
            shapes = PipelineShapes.derive(index, params, n, q_arr.shape[1])
            marks = counts = None
            if batch is not None:
                # Stage marks are CUDA events: only on a card.
                marks = [] if index.device.type == "cuda" else None
                counts = {}
            ids, scores, overflow = search_pipeline(
                index, q_t, mask_t, subset_t, shapes, marks=marks, counts=counts
            )
            return PendingSearch(
                index, queries, params, subset, n, ids, scores, overflow, shapes,
                batch=batch, marks=marks, counts=counts,
            )

        # Grid-only int8 refinement: the kernel stage returns top-R candidates
        # (SearchParameters.refine_depth; -1 disables, 0 means max(4k, 32)),
        # re-ranked exactly below or at result() time.
        refine_k = 0
        top_k_eff = params.top_k
        if (
            index.grid_only
            and index.grid_is_int8
            and index.refine_side != "none"
            and params.refine_depth >= 0
        ):
            depth = params.refine_depth or max(4 * params.top_k, 32)
            top_k_eff = min(max(depth, params.top_k), max(index.num_documents, 1))
            refine_k = params.top_k

        if index.grid_buckets:
            ids, scores = exact_search_split(index, q_t, subset_t, top_k=top_k_eff)
        else:
            top_k_eff = min(top_k_eff, max(index.num_docs_padded - 1, 1))
            ids, scores = exact_search_pipeline(
                index,
                q_t,
                mask_t,
                subset_t,
                top_k=top_k_eff,
                doc_tile=default_doc_tile(n, q_arr.shape[1], index.token_axis()),
                precision=params.stage1_precision,
                use_kernel=kernel_eligible,
            )
        if refine_k and index.refine_side == "device" and top_k_eff <= 128:
            # Per-query device refine: candidates never leave the device.
            ids, scores = refine_own_topk_device(index, q_t, mask_t, ids, refine_k)
            refine_k = 0
        return PendingSearch(
            index, queries, params, subset, n, ids, scores, refine_k=refine_k,
            batch=batch,
        )


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
