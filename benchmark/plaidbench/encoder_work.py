"""The ColBERT encoder's work arithmetic, from token counts and the
configuration's widths (HF ModernBERT's keys), and its reading from the
program's counters.

A ModernBERT forward over N live tokens does, per layer, the dense
products 2 N h (3h) (Wqkv), 2 N h h (Wo), 2 N h (2 ff) (Wi) and 2 N ff h
(the MLP's Wo), and the attention 4 H D P for P query-key pairs within a
document (Q K^T and P V, 2 operations a multiply-add each): L^2 pairs on a
global layer, the band's on a local one. The projection adds 2 N h dim.
Norms, RoPE, GeGLU and the softmax are not counted. The attention kernel
reads q, k and v and writes its output once a layer: 8 N H D bytes in
bf16.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import numpy as np

from plaidbench.peaks import HBM_BYTES_PER_S, PEAK_OPS_PER_S

BF16_BYTES = 2


def layer_kinds(cfg: dict) -> tuple:
    """(global layers, local layers)."""
    n = int(cfg["num_hidden_layers"])
    g = len(range(0, n, int(cfg["global_attn_every_n_layers"])))
    return g, n - g


def attention_pairs(lens: Sequence[int], cfg: dict) -> tuple:
    """Query-key pairs per head of one forward over documents of `lens`,
    summed over its (global, local) layers."""
    lens = np.asarray(lens, np.int64)
    w = int(cfg["local_attention"]) // 2
    band = np.where(lens <= w + 1, lens * lens, lens * (2 * w + 1) - w * (w + 1))
    g, loc = layer_kinds(cfg)
    return g * int((lens * lens).sum()), loc * int(band.sum())


def dense_ops(tokens: int, cfg: dict) -> float:
    """The dense products and the projection of a forward over `tokens`."""
    h, ff = float(cfg["hidden_size"]), float(cfg["intermediate_size"])
    per_layer = 2 * h * 3 * h + 2 * h * h + 2 * h * 2 * ff + 2 * ff * h
    return float(tokens) * (per_layer * int(cfg["num_hidden_layers"])
                            + 2 * h * float(cfg["embedding_dim"]))


def attention_ops(pairs: float, cfg: dict) -> float:
    return 4.0 * float(cfg["hidden_size"]) * float(pairs)  # H D = hidden


def forward_ops(lens: Sequence[int], cfg: dict) -> float:
    """A packed forward's model operations."""
    return dense_ops(int(np.sum(lens)), cfg) + attention_ops(sum(attention_pairs(lens, cfg)), cfg)


def request_ops(query_len: int, doc_lens: Sequence[int], cfg: dict) -> float:
    """One rerank request: the query's forward, the documents' forward and
    the MaxSim scoring (2 Tq T dim)."""
    return (forward_ops([query_len], cfg) + forward_ops(doc_lens, cfg)
            + 2.0 * query_len * float(np.sum(doc_lens)) * float(cfg["embedding_dim"]))


def attention_bound_s(forwards: Iterable[Dict[str, float]], cfg: dict) -> float:
    """The least time the card needs for the attention of `forwards` (the
    program's per-forward counters `encode.live_tokens`,
    `encode.attn_pairs_global`, `encode.attn_pairs_local`): each layer's
    launch bound by its operations at the bf16 peak or its bytes at the
    memory's rate, whichever is longer."""
    g, loc = layer_kinds(cfg)
    peak = PEAK_OPS_PER_S["bf16"]
    total = 0.0
    for f in forwards:
        layer_bytes = 4.0 * BF16_BYTES * f["encode.live_tokens"] * float(cfg["hidden_size"])
        for n_layers, pairs in ((g, f["encode.attn_pairs_global"]),
                                (loc, f["encode.attn_pairs_local"])):
            if n_layers:
                total += max(attention_ops(pairs, cfg) / peak, n_layers * layer_bytes / HBM_BYTES_PER_S)
    return total


def forwards_of(records: List) -> List[Dict[str, float]]:
    """The program's counter records grouped by forward: each forward
    records `encode.live_tokens` first, then its other counters."""
    out: List[Dict[str, float]] = []
    for r in records:
        if r.kind != "count" or not r.name.startswith("encode."):
            continue
        if r.name == "encode.live_tokens":
            out.append({})
        if out:
            out[-1][r.name] = r.value
    return out


def request_mean(records: List, kind: str, name: str):
    """Mean over the requests traced (the batches with any `encode.`
    record) of the sum of their `name` records of `kind`; None when no
    such record was made."""
    per: Dict[int, float] = {}
    found = False
    for r in records:
        if r.name.startswith("encode.") and r.batch is not None:
            per.setdefault(r.batch, 0.0)
            if r.kind == kind and r.name == name:
                per[r.batch] += r.value
                found = True
    return sum(per.values()) / len(per) if found else None
