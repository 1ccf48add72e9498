"""Exhaustive MaxSim search: score every document.

PyTorch counterpart of `nextplaid_tpu.index.exact` for the pinned bf16 grid
and the decompress-on-the-fly scan. Below a corpus-size threshold, scoring
every document is both fast and exact (recall 1.0 by construction), so
`search_batch` routes here (SearchParameters.mode = "auto").

Two scorers:
  - `_exact_search_kernel`: the fused MaxSim kernel over the pinned grid
    (ops.maxsim_kernel), all queries in one launch;
  - `exact_all_scores`: a tiled scan, per doc tile either a slice of the
    pinned grid or the tile's tokens decompressed once for the whole query
    batch, then one matmul, masked max over doc tokens, sum over query
    tokens. Peak memory is one tile's similarity block.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from nextplaid_tpu_torch.index.container import DeviceIndex, decompress_docs
from nextplaid_tpu_torch.ops.maxsim_kernel import maxsim_grid_scores

NEG_INF = float("-inf")


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


def _exact_search_kernel(
    index: DeviceIndex,
    queries: torch.Tensor,
    subset_mask: Optional[torch.Tensor],
    top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused-kernel exhaustive scoring over the pinned bf16 grid, all query
    blocks in one launch. Padded query tokens are zero vectors by
    construction (search._pad_queries), so no query mask is needed."""
    q_n, tq, d = queries.shape
    nd_cap = index.num_docs_padded - 1
    grid = index.token_grid
    doclens = torch.zeros(grid.shape[0], dtype=torch.int32, device=grid.device)
    doclens[: index.num_docs_padded] = index.doclens
    qflat = queries.reshape(q_n * tq, d).to(grid.device, torch.bfloat16)
    scores = maxsim_grid_scores(qflat, grid, doclens, tq=tq)
    scores = scores[:, : max(nd_cap, 1)]
    valid = torch.arange(scores.shape[1], device=grid.device) < index.num_documents
    if subset_mask is not None:
        valid &= subset_mask[: scores.shape[1]]
    scores = scores.masked_fill(~valid[None, :], NEG_INF)
    return _finish(scores, top_k, nd_cap)
