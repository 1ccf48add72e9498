"""IR ranking metrics: NDCG@k, MAP, Recall@k, Precision@k, MRR@k.

Pure-Python/numpy implementations matching the conventions the reference's
harness gets from `ranx` (benchmark_scifact_docker.py:261-293):

- A *run* is {query_key: {doc_id: score}}; a *qrels* is
  {query_key: {doc_id: relevance_int}}. Keys must align between the two.
- Ranking is by descending score; ties broken by doc id (ascending) so
  results are deterministic across dict orderings.
- NDCG uses the Jarvelin & Kekalainen formulation with LINEAR gains
  (DCG = sum rel_i / log2(i + 1), i 1-based) — ranx's `ndcg` default.
  For binary qrels (all BEIR datasets used in BASELINE.md) the linear and
  exponential forms coincide.
- MAP / Recall / MRR treat rel > 0 as relevant. AP divides by the TOTAL
  number of relevant docs in qrels (not the number retrieved), capped at k
  when a cutoff is given — trec_eval semantics.
- Queries present in qrels but absent from the run score 0 for every
  metric; queries in the run but not in qrels are ignored. The mean is
  over qrels queries (what `ranx.evaluate` does).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

Run = Mapping[str, Mapping[str, float]]
Qrels = Mapping[str, Mapping[str, int]]


def _ranked_ids(scored: Mapping[str, float]) -> List[str]:
    """Doc ids sorted by (-score, doc_id) — deterministic under ties."""
    return [d for d, _ in sorted(scored.items(), key=lambda kv: (-kv[1], kv[0]))]


def ndcg_at_k(ranked: Sequence[str], rels: Mapping[str, int], k: int) -> float:
    """NDCG@k for one query (linear gains)."""
    gains = [max(0, rels.get(d, 0)) for d in ranked[:k]]
    dcg = sum(g / math.log2(i + 2) for i, g in enumerate(gains))
    ideal = sorted((r for r in rels.values() if r > 0), reverse=True)[:k]
    idcg = sum(g / math.log2(i + 2) for i, g in enumerate(ideal))
    return dcg / idcg if idcg > 0 else 0.0


def average_precision(
    ranked: Sequence[str], rels: Mapping[str, int], k: int | None = None
) -> float:
    """AP (binary relevance). k=None means the full retrieved list."""
    relevant = {d for d, r in rels.items() if r > 0}
    if not relevant:
        return 0.0
    denom = min(len(relevant), k) if k is not None else len(relevant)
    cut = ranked[:k] if k is not None else ranked
    hits, total = 0, 0.0
    for i, d in enumerate(cut):
        if d in relevant:
            hits += 1
            total += hits / (i + 1)
    return total / denom


def recall_at_k(ranked: Sequence[str], rels: Mapping[str, int], k: int) -> float:
    relevant = {d for d, r in rels.items() if r > 0}
    if not relevant:
        return 0.0
    return len(relevant.intersection(ranked[:k])) / len(relevant)


def precision_at_k(
    ranked: Sequence[str], rels: Mapping[str, int], k: int
) -> float:
    relevant = {d for d, r in rels.items() if r > 0}
    return len(relevant.intersection(ranked[:k])) / k if k else 0.0


def mrr_at_k(ranked: Sequence[str], rels: Mapping[str, int], k: int) -> float:
    relevant = {d for d, r in rels.items() if r > 0}
    for i, d in enumerate(ranked[:k]):
        if d in relevant:
            return 1.0 / (i + 1)
    return 0.0


def _parse_metric(name: str) -> Tuple[str, int | None]:
    base, _, cut = name.partition("@")
    return base.strip().lower(), (int(cut) if cut else None)


def evaluate(
    qrels: Qrels,
    run: Run,
    metrics: Iterable[str] = ("map", "ndcg@10", "recall@10", "recall@100"),
) -> Dict[str, float]:
    """Mean metric values over all qrels queries.

    Metric names: "ndcg@K", "map" / "map@K", "recall@K", "precision@K",
    "mrr" / "mrr@K" (mrr without a cutoff uses the full list).
    """
    parsed = [(m, *_parse_metric(m)) for m in metrics]
    sums = {m: 0.0 for m, _, _ in parsed}
    n = 0
    for q, rels in qrels.items():
        n += 1
        ranked = _ranked_ids(run.get(q, {}))
        for name, base, k in parsed:
            if base == "ndcg":
                if k is None:
                    raise ValueError("ndcg requires a cutoff, e.g. ndcg@10")
                v = ndcg_at_k(ranked, rels, k)
            elif base == "map":
                v = average_precision(ranked, rels, k)
            elif base == "recall":
                if k is None:
                    raise ValueError("recall requires a cutoff")
                v = recall_at_k(ranked, rels, k)
            elif base == "precision":
                if k is None:
                    raise ValueError("precision requires a cutoff")
                v = precision_at_k(ranked, rels, k)
            elif base == "mrr":
                v = mrr_at_k(ranked, rels, k if k is not None else len(ranked))
            else:
                raise ValueError(f"unknown metric: {name}")
            sums[name] += v
    if n == 0:
        return {m: 0.0 for m, _, _ in parsed}
    return {m: sums[m] / n for m, _, _ in parsed}
