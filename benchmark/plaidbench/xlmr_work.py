"""jina-colbert-v2's work arithmetic, from token counts and the
configuration's widths (config.json's keys), and the bound of global
attention read from the program's counters.

A forward of the rotary XLM-RoBERTa over N live tokens does, per layer,
the dense products 2 N h (3h) (the fused Wqkv), 2 N h h (out_proj),
2 N h ff (fc1) and 2 N ff h (fc2), and the attention 4 H D P for the
P = L^2 query-key pairs of each document of L tokens (Q K^T and P V, 2
operations a multiply-add each): every layer is global. The projection adds
2 N h dim, the MaxSim scoring 2 Tq T dim. Biases, LayerNorms, RoPE, GELU
and the softmax are not counted. A global attention launch reads q, k and
v and writes its output once: 8 N H D bytes in bf16.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence

import numpy as np

from plaidbench.peaks import HBM_BYTES_PER_S, PEAK_OPS_PER_S

BF16_BYTES = 2


def attention_pairs(lens: Sequence[int], cfg: dict) -> int:
    """Query-key pairs per head of one forward over documents of `lens`,
    summed over its layers (all global)."""
    lens = np.asarray(lens, np.int64)
    return int(cfg["num_hidden_layers"]) * int((lens * lens).sum())


def dense_ops(tokens: int, cfg: dict) -> float:
    """The dense products and the projection of a forward over `tokens`."""
    h, ff = float(cfg["hidden_size"]), float(cfg["intermediate_size"])
    per_layer = 2 * h * 3 * h + 2 * h * h + 2 * h * ff + 2 * ff * h
    return float(tokens) * (per_layer * int(cfg["num_hidden_layers"])
                            + 2 * h * float(cfg["embedding_dim"]))


def attention_ops(pairs: float, hidden: float) -> float:
    return 4.0 * float(hidden) * float(pairs)  # H D = hidden


def forward_ops(lens: Sequence[int], cfg: dict) -> float:
    """A packed forward's model operations."""
    return (dense_ops(int(np.sum(lens)), cfg)
            + attention_ops(attention_pairs(lens, cfg), cfg["hidden_size"]))


def request_ops(query_len: int, doc_lens: Sequence[int], cfg: dict) -> float:
    """One rerank request: the query's forward, the documents' forward and
    the MaxSim scoring (2 Tq T dim)."""
    return (forward_ops([query_len], cfg) + forward_ops(doc_lens, cfg)
            + 2.0 * query_len * float(np.sum(doc_lens)) * float(cfg["embedding_dim"]))


def global_attention_bound_s(forwards: Iterable[Dict[str, float]], hidden: float) -> float:
    """The least time the card needs for the global attention of
    `forwards` (each a forward's counters `encode.live_tokens`,
    `encode.attn_pairs_global` and `encode.attn_layers_global`, which the
    program records for every packed forward of either family): per
    forward, its pairs' operations at the bf16 peak or its launches' bytes
    at the memory's rate, whichever is longer."""
    total = 0.0
    for f in forwards:
        launch_bytes = 4.0 * BF16_BYTES * f["encode.live_tokens"] * float(hidden)
        total += max(attention_ops(f["encode.attn_pairs_global"], hidden) / PEAK_OPS_PER_S["bf16"],
                     f["encode.attn_layers_global"] * launch_bytes / HBM_BYTES_PER_S)
    return total
