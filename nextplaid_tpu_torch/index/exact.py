"""Exhaustive MaxSim search: score every document.

PyTorch counterpart of `nextplaid_tpu.index.exact`. Below a corpus-size
threshold, or whenever a token grid is pinned, scoring every document is
both fast and exact (recall 1.0 by construction for bf16), so
`search_batch` routes here (SearchParameters.mode = "auto").

Scorers:
  - `_exact_search_kernel`: the fused MaxSim kernel over the pinned single
    grid (ops.maxsim_kernel; bf16, or int8 with device-side query
    quantization);
  - `exact_search_split`: the kernels over bucketed-Td grids, one launch per
    bucket, merged by `_finalize_topk_perm`;
  - `exact_all_scores`: a tiled scan, per doc tile either a slice of the
    pinned grid (int8 tiles dequantized) or the tile's tokens decompressed
    once for the whole query batch, then one matmul, masked max over doc
    tokens, sum over query tokens. Peak memory is one tile's similarity
    block.

Grid-only int8 serving adds the refinement rerank: the kernel stage returns
top-R candidates, which are re-scored exactly from the codes and residuals
(`refine_own_topk_device`, or `refine_topk` over the batch's union).

The JAX package splits single mega grids into separate dispatches only
because one fused XLA program at that size does not compile in time
(`SPLIT_DISPATCH_SLOTS`); eager PyTorch has no such limit, so a single grid
always takes `_exact_search_kernel`. Its super-row refine table
(`ops/refine_gather.py`) works around TPU lane tiling; here the refinement
gathers corpus rows directly.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from nextplaid_tpu_torch.index.container import (
    DeviceIndex,
    decompress_docs,
    decompress_windows,
)
from nextplaid_tpu_torch.ops.maxsim_kernel import (
    maxsim_grid_scores,
    maxsim_grid_scores_int8i,
)

NEG_INF = float("-inf")
# Score-block budget of one kernel launch: queries are blocked so that the
# [Q, ND_grid] f32 scores stay below it (473K rows x 64 queries is 121 MB).
SCORE_BLOCK_BYTES = 512 << 20


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def default_doc_tile(num_queries: int, query_tokens: int, td: int) -> int:
    """Tile size targeting ~128 MB similarity blocks."""
    budget = 128 << 20
    block_bytes = max(num_queries * query_tokens * td * 4, 1)
    return int(np.clip(budget // block_bytes, 8, 512))


def _topk_wide(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the doc axis -> (values, int32 ids). (The JAX package's
    approx_max_k route only works around a TPU compile-time limit.)"""
    vals, ids = torch.topk(scores, min(k, scores.shape[1]), dim=1)
    return vals, ids.to(torch.int32)


def _finish(scores: torch.Tensor, top_k: int, nd_cap: int):
    k = min(top_k, max(nd_cap, 1))
    final_scores, final_ids = _topk_wide(scores, k)
    final_ids = torch.where(
        torch.isfinite(final_scores), final_ids, torch.full_like(final_ids, -1)
    )
    return final_ids, final_scores


def exact_all_scores(
    index: DeviceIndex,
    queries: torch.Tensor,
    qmask: torch.Tensor,
    doc_tile: int,
    precision: str = "highest",
) -> torch.Tensor:
    """Exhaustive MaxSim scores [Q, num_docs_padded - 1] via the tile scan;
    docs beyond num_documents come back -inf.

    precision "highest" scores f32 queries against f32 tokens; otherwise
    queries and tokens are rounded to bf16 and the products summed in f32.
    """
    q_n, tq, d = queries.shape
    nd = index.num_documents
    n_range = max(index.num_docs_padded - 1, 1)
    td = index.token_axis()
    dev = index.device
    q_in = queries.to(dev, torch.float32)
    if precision != "highest":
        q_in = q_in.to(torch.bfloat16).float()
    q_flat = q_in.reshape(q_n * tq, d)
    t_ar = torch.arange(td, device=dev)
    out = torch.empty(q_n, n_range, dtype=torch.float32, device=dev)
    for start in range(0, n_range, doc_tile):
        ids = torch.arange(start, min(start + doc_tile, n_range), device=dev)
        n = ids.shape[0]
        if index.token_grid is not None:
            emb = index.token_grid[start : start + n].float()
            if index.token_scales is not None:
                # int8 grid: dequantize; queries stay unquantized.
                emb = emb * index.token_scales[start : start + n].float()[:, :, None]
                if precision != "highest":
                    emb = emb.to(torch.bfloat16).float()
        else:
            emb = decompress_docs(index, ids, td)
            if precision != "highest":
                emb = emb.to(torch.bfloat16).float()
        lens = torch.where(ids < nd, index.doclens[ids], 0)
        sim = (q_flat @ emb.reshape(n * td, d).T).view(q_n, tq, n, td)
        valid = t_ar[None, :] < lens[:, None]  # [n, Td]
        sim = sim.masked_fill(~valid[None, None], NEG_INF)
        per_tok = sim.amax(dim=-1)  # [Q, Tq, n]
        keep = qmask.to(dev)[:, :, None] & torch.isfinite(per_tok)
        scores = torch.where(keep, per_tok, torch.zeros_like(per_tok)).sum(dim=1)
        out[:, start : start + n] = torch.where(
            (ids < nd)[None, :], scores, torch.full_like(scores, NEG_INF)
        )
    return out


def exact_search_pipeline(
    index: DeviceIndex,
    queries: torch.Tensor,  # [Q, Tq, d], zero-padded
    qmask: torch.Tensor,  # [Q, Tq] bool
    subset_mask: Optional[torch.Tensor],  # [num_docs_padded] bool
    top_k: int,
    doc_tile: int,
    precision: str = "highest",
    use_kernel: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (doc_ids [Q, top_k] int32 with -1 invalid, scores [Q, top_k])."""
    if use_kernel and index.token_grid is not None:
        return _exact_search_kernel(index, queries, subset_mask, top_k)
    all_scores = exact_all_scores(index, queries, qmask, doc_tile, precision)
    if subset_mask is not None:
        all_scores = all_scores.masked_fill(
            ~subset_mask[None, : all_scores.shape[1]], NEG_INF
        )
    return _finish(all_scores, top_k, index.num_docs_padded - 1)


def quantize_queries_int8(qf32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization of flattened query tokens.

    Returns (q_int8 [Qf, d], scales [Qf] f32): scale = maxabs / 127 in f32,
    q = clip(round(x / scale), -127, 127), rounding half to even as
    `jnp.round` does. Zero rows (padded query tokens) get scale 0, which the
    kernels rely on to zero their score contribution."""
    qf32 = qf32.float()
    maxabs = qf32.abs().amax(dim=-1)
    qscale = torch.where(maxabs > 0, maxabs / 127.0, torch.zeros_like(maxabs))
    denom = torch.where(qscale > 0, qscale, torch.ones_like(qscale))
    qi8 = torch.clamp(torch.round(qf32 / denom[:, None]), -127, 127).to(torch.int8)
    return qi8, qscale


def _grid_scores(
    grid: torch.Tensor,
    scales: Optional[torch.Tensor],
    doclens: Optional[torch.Tensor],
    queries: torch.Tensor,
) -> torch.Tensor:
    """[Q, rows] kernel scores of `queries` [Q, Tq, d] over one grid: int8
    (queries quantized on the device) when `scales` is given, else bf16
    with `doclens` [rows]."""
    q_n, tq, d = queries.shape
    qflat = queries.reshape(q_n * tq, d).to(grid.device)
    if scales is not None:
        qi8, qscale = quantize_queries_int8(qflat)
        return maxsim_grid_scores_int8i(qi8, qscale, grid, scales, tq=tq)
    return maxsim_grid_scores(qflat.to(torch.bfloat16), grid, doclens, tq=tq)


def _finalize_topk(
    scores: torch.Tensor,
    nd_cap: int,
    n_docs: int,
    subset_mask: Optional[torch.Tensor],
    top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask padding and the subset and take top-k over a [Q, rows] score
    block. `scores` may be grid-row wide (grids carry slack rows); every live
    doc id is below `nd_cap` (num_docs_padded - 1) and the subset mask's
    width, so the row axis is cut to the shorter of the two."""
    if subset_mask is not None:
        nd_cap = min(nd_cap, subset_mask.shape[0])
    scores = scores[:, : max(nd_cap, 1)]
    valid = torch.arange(scores.shape[1], device=scores.device) < n_docs
    if subset_mask is not None:
        valid &= subset_mask[: scores.shape[1]]
    return _finish(scores.masked_fill(~valid[None, :], NEG_INF), top_k, nd_cap)


def _exact_search_kernel(
    index: DeviceIndex,
    queries: torch.Tensor,
    subset_mask: Optional[torch.Tensor],
    top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused-kernel exhaustive scoring over the pinned single grid. Padded
    query tokens are zero vectors by construction (search._pad_queries), so
    no query mask is needed. Queries run in blocks that keep the [Q, rows]
    score block under SCORE_BLOCK_BYTES."""
    q_n = queries.shape[0]
    grid = index.token_grid
    doclens = None
    if index.token_scales is None:
        doclens = torch.zeros(grid.shape[0], dtype=torch.int32, device=grid.device)
        doclens[: index.num_docs_padded] = index.doclens
    q_block = max(1, SCORE_BLOCK_BYTES // (grid.shape[0] * 4))
    outs = [
        _finalize_topk(
            _grid_scores(grid, index.token_scales, doclens, queries[s : s + q_block]),
            index.num_docs_padded - 1, index.num_documents, subset_mask, top_k,
        )
        for s in range(0, q_n, q_block)
    ]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def _finalize_topk_perm(
    score_blocks: Sequence[torch.Tensor],
    perm_blocks: Sequence[torch.Tensor],
    subset_mask: Optional[torch.Tensor],
    top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bucketed finalize: per bucket, mask alignment-padding rows (perm < 0)
    and the subset, take its top-k and translate rows to doc ids through the
    bucket's perm slice; then a final top-k over the [Q, sum k_b] winners."""
    parts_s, parts_i = [], []
    for scores, perm in zip(score_blocks, perm_blocks):
        valid = perm >= 0
        if subset_mask is not None:
            valid &= subset_mask[torch.clamp(perm, 0, subset_mask.shape[0] - 1).long()]
        scores = scores.masked_fill(~valid[None, :], NEG_INF)
        s_b, rows = _topk_wide(scores, min(top_k, scores.shape[1]))
        parts_s.append(s_b)
        parts_i.append(
            torch.where(torch.isfinite(s_b), perm[rows.long()], torch.full_like(rows, -1))
        )
    merged_s = torch.cat(parts_s, dim=1)
    merged_i = torch.cat(parts_i, dim=1)
    final_scores, slots = torch.topk(merged_s, min(top_k, merged_s.shape[1]), dim=1)
    final_ids = torch.gather(merged_i, 1, slots)
    final_ids = torch.where(
        torch.isfinite(final_scores), final_ids, torch.full_like(final_ids, -1)
    )
    return final_ids, final_scores


def exact_search_split(
    index: DeviceIndex,
    queries: torch.Tensor,  # [Q, Tq, d]
    subset_mask: Optional[torch.Tensor],
    top_k: int,
    q_block: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kernel search over bucketed-Td grids (`index.grid_buckets`):
    per `q_block` queries, one kernel launch per bucket, merged by
    `_finalize_topk_perm`. Returns (ids [Q, k] int32 with -1 invalid,
    scores [Q, k])."""
    if not index.grid_buckets:
        raise ValueError("exact_search_split serves bucketed grids only")
    q_n = queries.shape[0]
    bounds = np.cumsum([0] + [g.shape[0] for g in index.grid_buckets])
    perm_slices = [
        index.grid_perm[int(bounds[b]) : int(bounds[b + 1])]
        for b in range(len(index.grid_buckets))
    ]
    len_slices = [
        index.grid_doclens[int(bounds[b]) : int(bounds[b + 1])]
        for b in range(len(index.grid_buckets))
    ]
    scale_list = list(index.scale_buckets) or [None] * len(index.grid_buckets)
    outs = []
    for s in range(0, q_n, q_block):
        q = queries[s : s + q_block]
        blocks = [
            _grid_scores(grid, scale_list[b], len_slices[b], q)
            for b, grid in enumerate(index.grid_buckets)
        ]
        outs.append(_finalize_topk_perm(blocks, perm_slices, subset_mask, top_k))
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


# ---------------------------------------------------------------------------
# Grid-only refinement rerank (int8 recall stage -> exact residual scores)
# ---------------------------------------------------------------------------
# The int8 grid quantizes every token to 8 bits and costs some recall. The
# rerank restores exactness the reference way (next-plaid search.rs:460-493:
# approximate recall stage + exact rerank of the survivors): the kernel
# stage returns top-R per query, and their residual codes are decompressed
# and re-scored in f32. Refined scores equal the f32 exhaustive oracle's by
# construction (same decompress + MaxSim). Refinement is plain XLA in the
# JAX package, so it stays plain PyTorch here.


def _refine_td(max_doclen: int) -> int:
    return max(_round_up(max(max_doclen, 1), 32), 32)


def _refine_scores_scan(
    queries, qmask, codes, res, lens_u, offs_u, centroids, bucket_weights,
    nbits: int, td: int, tile: int,
) -> torch.Tensor:
    """Exact MaxSim [Q, cap] of every query against `cap` candidate docs
    whose tokens start at offs_u in codes/res, in tiles of `tile` docs."""
    cap = lens_u.shape[0]
    out = torch.empty(queries.shape[0], cap, dtype=torch.float32, device=queries.device)
    t_ar = torch.arange(td, device=queries.device)
    for s in range(0, cap, tile):
        lens = lens_u[s : s + tile]
        emb = decompress_windows(
            codes, res, offs_u[s : s + tile], lens, td, centroids,
            bucket_weights, nbits,
        )  # [n, td, d] f32, decompressed once for the whole batch
        sim = torch.einsum("qtd,njd->qntj", queries, emb)
        valid = t_ar[None, :] < lens[:, None]
        sim = sim.masked_fill(~valid[None, :, None, :], NEG_INF)
        per_tok = sim.amax(dim=-1)  # [Q, n, Tq]
        keep = qmask[:, None, :] & torch.isfinite(per_tok)
        scores = torch.where(keep, per_tok, torch.zeros_like(per_tok)).sum(dim=-1)
        out[:, s : s + tile] = scores.masked_fill((lens <= 0)[None, :], NEG_INF)
    return out


def refine_own_topk_device(
    index: DeviceIndex,
    queries: torch.Tensor,  # [Q, Tq, d] f32
    qmask: torch.Tensor,  # [Q, Tq] bool
    cand_ids: torch.Tensor,  # [Q, R] int32 recall candidates (-1 invalid)
    top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each query re-scores only its own top-R candidates (reference rerank
    depth semantics, search.rs:460-469) straight from the resident codes and
    residuals, and keeps its top-k, all on the device. Returns ([Q, k] ids,
    scores)."""
    dev = index.device
    q_n, r = cand_ids.shape
    td = _refine_td(index.max_doclen)
    d = index.dim
    # Bound the decompress transient (~q_tile * R * td * d * 4) to ~150 MB.
    # (The JAX package also caps q_tile at 8 to keep its XLA program small.)
    q_tile = max(1, (150 << 20) // max(r * td * d * 4, 1))
    queries = queries.to(dev, torch.float32)
    qmask = qmask.to(dev)
    nd_pad = index.num_docs_padded
    t_ar = torch.arange(td, device=dev)
    scores = torch.empty(q_n, r, dtype=torch.float32, device=dev)
    for s in range(0, q_n, q_tile):
        ids_t = cand_ids[s : s + q_tile].to(dev)
        qt = ids_t.shape[0]
        valid = (ids_t >= 0) & (ids_t < nd_pad)
        safe = torch.clamp(ids_t, 0, nd_pad - 1).long()
        lens = torch.where(valid, index.doclens[safe], 0)  # [qt, R]
        emb = decompress_windows(
            index.codes, index.residuals, index.doc_offsets[safe].reshape(-1),
            lens.reshape(-1), td, index.centroids, index.bucket_weights,
            index.nbits,
        ).view(qt, r, td, d)
        sim = torch.einsum("qtd,qrjd->qrtj", queries[s : s + qt], emb)
        tok_valid = t_ar[None, None, :] < lens[..., None]  # [qt, R, td]
        sim = sim.masked_fill(~tok_valid[:, :, None, :], NEG_INF)
        per_tok = sim.amax(dim=-1)  # [qt, R, Tq]
        keep = qmask[s : s + qt, None, :] & torch.isfinite(per_tok)
        sc = torch.where(keep, per_tok, torch.zeros_like(per_tok)).sum(dim=-1)
        scores[s : s + qt] = sc.masked_fill(lens <= 0, NEG_INF)
    top_scores, slots = torch.topk(scores, min(top_k, r), dim=1)
    top_ids = torch.gather(cand_ids.to(dev), 1, slots)
    top_ids = torch.where(
        torch.isfinite(top_scores), top_ids, torch.full_like(top_ids, -1)
    )
    return top_ids, top_scores


def refine_topk(
    index: DeviceIndex,
    q_arr: np.ndarray,  # [Q, Tq, d] padded queries
    q_mask: np.ndarray,  # [Q, Tq]
    cand_ids: np.ndarray,  # [n, R] int32 (-1 invalid) from the int8 stage
    top_k: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Re-score the candidate union exactly; return ([n, k] ids, scores).

    Each query's final top-k is drawn from the whole batch union (a doc
    surfaced by another query's recall stage may out-score this query's own
    candidates; scoring it too only raises recall). With resident codes and
    residuals the union is scored on the device straight from them; else
    its token rows are gathered on the host (`HostRefineData`) and shipped
    for the re-score."""
    n = cand_ids.shape[0]
    valid = cand_ids >= 0
    uniq = np.unique(cand_ids[valid]).astype(np.int64)
    uniq = uniq[uniq < index.num_documents]
    if uniq.size == 0:
        k = min(top_k, cand_ids.shape[1])
        return cand_ids[:, :k], np.full((n, k), -np.inf, np.float32)

    dev = index.device
    queries = torch.from_numpy(np.asarray(q_arr, np.float32)).to(dev)
    qmask = torch.from_numpy(np.asarray(q_mask)).to(dev)
    if index.codes.shape[0] > 0:
        ids = torch.from_numpy(uniq).to(dev)
        lens_u = index.doclens[ids]
        offs_u = index.doc_offsets[ids]
        codes, res = index.codes, index.residuals
        td = _refine_td(index.max_doclen)
    else:
        refine = index.refine_host
        assert refine is not None
        codes_h, res_h, lens_h = refine.gather(uniq)
        offs_h = np.zeros(len(uniq), np.int64)
        np.cumsum(lens_h[:-1], out=offs_h[1:])
        codes = torch.from_numpy(codes_h).to(dev)
        res = torch.from_numpy(res_h).to(dev)
        lens_u = torch.from_numpy(lens_h).to(dev)
        offs_u = torch.from_numpy(offs_h).to(dev)
        td = _refine_td(int(lens_h.max()))
    scores = _refine_scores_scan(
        queries, qmask, codes, res, lens_u, offs_u, index.centroids,
        index.bucket_weights, index.nbits, td, tile=128,
    )[:n].cpu().numpy()
    return _refine_finalize(uniq, scores, top_k, n)


def _refine_finalize(uniq, scores, top_k, n):
    k = min(top_k, len(uniq))
    top_slots = np.argpartition(-scores, k - 1, axis=1)[:, :k]
    top_scores = np.take_along_axis(scores, top_slots, axis=1)
    order = np.argsort(-top_scores, axis=1, kind="stable")
    top_slots = np.take_along_axis(top_slots, order, axis=1)
    top_scores = np.take_along_axis(top_scores, order, axis=1)
    top_ids = uniq[top_slots].astype(np.int32)
    top_ids = np.where(np.isfinite(top_scores), top_ids, -1)
    return top_ids, top_scores.astype(np.float32)
