"""MaxSim (ColBERT late-interaction) scoring: the plain f32 oracle.

PyTorch counterpart of `nextplaid_tpu.ops.maxsim` (next-plaid
src/maxsim.rs:42-294). Padded query tokens contribute 0 to the sum, padded
document tokens are excluded from the max.
"""

from __future__ import annotations

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
