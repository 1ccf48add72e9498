"""MaxSim (ColBERT late-interaction) scoring: the plain f32 oracle.

PyTorch counterpart of `nextplaid_tpu.ops.maxsim` (next-plaid
src/maxsim.rs:42-294). Padded query tokens contribute 0 to the sum, padded
document tokens are excluded from the max.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def maxsim_score(query: torch.Tensor, doc: torch.Tensor) -> torch.Tensor:
    """Single (query, doc) MaxSim: sum_t max_j <q_t, d_j>, in f32."""
    sim = query.float() @ doc.float().T
    return sim.max(dim=-1).values.sum()


def maxsim_batch(
    queries: torch.Tensor,
    docs: torch.Tensor,
    query_mask: torch.Tensor,
    doc_mask: torch.Tensor,
) -> torch.Tensor:
    """Batched masked MaxSim.

    Args:
      queries: [Q, Tq, d].
      docs: [B, Td, d].
      query_mask: [Q, Tq] bool — True for real query tokens.
      doc_mask: [B, Td] bool — True for real doc tokens.

    Returns:
      [Q, B] float32 scores; a doc with no real token scores 0.
    """
    sim = torch.einsum("qtd,bjd->qbtj", queries.float(), docs.float())
    sim = sim.masked_fill(~doc_mask[None, :, None, :], float("-inf"))
    per_token = sim.max(dim=-1).values  # [Q, B, Tq]
    keep = query_mask[:, None, :] & torch.isfinite(per_token)
    return torch.where(keep, per_token, torch.zeros_like(per_token)).sum(-1)


def maxsim_pairwise(
    queries: torch.Tensor,
    docs: torch.Tensor,
    query_mask: torch.Tensor,
    doc_mask: torch.Tensor,
) -> torch.Tensor:
    """Paired masked MaxSim: query i scored against doc slab i.

    Args:
      queries: [Q, Tq, d]; docs: [Q, R, Td, d] (per-query candidate slabs).
      query_mask: [Q, Tq]; doc_mask: [Q, R, Td].

    Returns:
      [Q, R] float32; a doc with no real token scores 0.
    """
    sim = torch.einsum("qtd,qrjd->qrtj", queries.float(), docs.float())
    sim = sim.masked_fill(~doc_mask[:, :, None, :], float("-inf"))
    per_token = sim.max(dim=-1).values  # [Q, R, Tq]
    keep = query_mask[:, None, :] & torch.isfinite(per_token)
    return torch.where(keep, per_token, torch.zeros_like(per_token)).sum(-1)


def rerank_scores(query: np.ndarray, docs: Sequence[np.ndarray], device) -> np.ndarray:
    """Exact f32 MaxSim of each of `docs` ([T_i, d] arrays) against
    `query` [Tq, d] on `device`, all documents in one batch: one copy of
    their tokens laid end to end, one [Tq, sum T_i] product, a per-document
    max and one readback. Returns [len(docs)] float32; a document with no
    token scores 0. The rerank handlers' scoring."""
    q = np.asarray(query, np.float32)
    if q.ndim != 2:
        raise ValueError(f"query must be [tokens, dim], got shape {q.shape}")
    arrs = [np.asarray(d, np.float32) for d in docs]
    for a in arrs:
        if a.ndim != 2 or a.shape[1] != q.shape[1]:
            raise ValueError(f"documents must be [tokens, {q.shape[1]}], got shape {a.shape}")
    if not arrs:
        return np.zeros(0, np.float32)
    lens = np.fromiter((a.shape[0] for a in arrs), np.int64, len(arrs))
    q_t = torch.from_numpy(q).to(device)
    d_t = torch.from_numpy(np.concatenate(arrs)).to(device)
    doc_of = torch.repeat_interleave(
        torch.arange(len(arrs), device=device), torch.from_numpy(lens).to(device),
        output_size=int(lens.sum()),
    )
    sim = q_t @ d_t.T  # [Tq, T]
    best = torch.full((q.shape[0], len(arrs)), float("-inf"), device=device)
    best.scatter_reduce_(1, doc_of.expand_as(sim), sim, "amax")
    best = torch.where(torch.isfinite(best), best, torch.zeros_like(best))
    return best.sum(0).cpu().numpy()
