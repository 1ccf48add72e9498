"""Index and search configuration.

A copy of `nextplaid_tpu.index.config` (the port imports nothing of the JAX
package), so configs serialize identically in both packages. Mirrors
next-plaid's `IndexConfig` (src/index.rs:43-102) and `SearchParameters`
(src/search.rs:28-69), plus the padding knobs of the JAX package's staged
pipeline. In this package `kernel="pallas"` keeps its name and means "force
the hand-written MaxSim kernel" (the CUDA kernel on a card, its plain PyTorch
version for CPU tensors); "auto" uses it when the index lives on CUDA.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


def default_start_from_scratch() -> int:
    """Env-overridable start-from-scratch doc threshold (lib.rs:47-64)."""
    v = os.environ.get("INDEX_DEFAULT_START_FROM_SCRATCH")
    if v is not None:
        try:
            return int(v)
        except ValueError:
            pass
    return 999


@dataclass
class IndexConfig:
    """Index build configuration (index.rs:43-102 defaults)."""

    nbits: int = 4
    batch_size: int = 50_000
    seed: Optional[int] = 42
    kmeans_niters: int = 4
    max_points_per_centroid: int = 256
    n_samples_kmeans: Optional[int] = None
    start_from_scratch: int = field(default_factory=default_start_from_scratch)
    # Accepted for reference-config compatibility (NEXT_PLAID_FORCE_CPU);
    # device placement is the entry points' `device` argument here, so this
    # field is inert.
    force_cpu: bool = False
    fts_tokenizer: str = "unicode61"
    # Centroid structure: "flat" = reference-identical k-means (chunked
    # running-max argmax handles K=131072+ at ~41 TFLOPS on v5e — measured,
    # scripts/profile_rq_gather.py); "rq" = opt-in two-level factored
    # codebook (ops/rq.py) for memory-bound deployments; "auto" = flat.
    centroid_structure: str = "auto"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "IndexConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass
class SearchParameters:
    """Staged-search operating point (search.rs:28-69 defaults)."""

    batch_size: int = 2000
    n_full_scores: int = 4096
    top_k: int = 10
    n_ivf_probe: int = 8
    centroid_batch_size: int = 100_000
    centroid_score_threshold: Optional[float] = 0.4

    # --- Fixed-shape bounds of the JAX package's staged pipeline (no
    # reference equivalent; the CPU engine uses dynamic Vecs). Candidate
    # buffers are padded to these sizes; overflow is logged, never silent
    # (SURVEY.md §7 "no silent caps").
    max_candidates: int = 0  # 0 = derived from index stats at pipeline build
    max_query_tokens: int = 64
    # Stage-1 matmul precision: "highest" (f32, reference parity) or
    # "default" (bf16 inputs with f32 accumulation; faster).
    stage1_precision: str = "highest"
    # Search strategy: "auto" picks exhaustive MXU scoring whenever a pinned
    # token grid exists (it fits HBM by construction; 350+ QPS at 30M
    # embeddings) or the corpus is below exact_max_embeddings; beyond that
    # it uses the staged pipeline. Measured at 72M embeddings on one v5e
    # (docs/benchmarks/megascale_tpu.json): unpinned exhaustive and staged
    # TIE on batch throughput (~7.5 QPS), but staged is 8x lower latency at
    # batch 1 (864 ms vs 6.9 s) — auto therefore prefers staged in the
    # unpinned mega regime, which is the interactive-serving default; batch
    # pipelines that want the exact scan force mode="exact".
    mode: str = "auto"
    exact_max_embeddings: int = 16_000_000
    # Candidate scope: "batch" scores every query against the whole batch
    # union exactly (recall >= reference at equal probes); "per_query"
    # restores the reference's semantics — each query ranks only documents
    # its own probes produced (search.rs candidate sets).
    candidate_scope: str = "batch"
    # Per-query approximate-prune depth: each query keeps this many docs
    # for the exact re-rank. 0 = auto (n_full_scores/4, the reference's
    # exact-rerank breadth, search.rs:468).
    prune_keep: int = 0
    # Approximate-score semantics for the prune:
    #   "cells": a doc's score is the sum of its probed cells' weights —
    #     cheap (no extra gathers) but rewards docs that merely appear in
    #     many probed lists; enough at moderate scale.
    #   "codes": the REFERENCE semantics (search.rs:448-457) as a stage 3b —
    #     survivors of a 4x-wider cells prune are re-scored by gathering
    #     each candidate's own token codes and taking the per-query-token
    #     max over those codes' centroid scores. Sharper prune: at megascale
    #     the same recall needs a fraction of the exact-rerank breadth.
    # DEFAULT "codes" since round 4: the JAX package's 72M frontier on a
    # TPU v5e (docs/benchmarks/megascale_codes_frontier.json) has codes >= cells
    # at matched recall above ~0.95 and strictly dominant at the >=0.99
    # band the reference's defaults target (15.8 QPS @ 0.9953 vs the best
    # cells point 13.7 @ 0.9906) — so the faithful semantics is also the
    # better operating point. "cells" remains the cheap low-recall knob.
    approx_score: str = "codes"
    # Flat posting-stream budget per query (entries gathered across all
    # probed cells). 0 = auto (4x the probe fan-out x average posting
    # length, floor 65536). Overflow is counted, reported, and handled per
    # overflow_policy.
    posting_budget: int = 0
    # Posting-budget overflow policy: "exact" (default) re-runs the batch
    # through exhaustive scoring — always correct, slow at huge scale;
    # "prune" drops the lowest-weight probed cells' postings (the tail of
    # the weight-sorted stream) and stays fast, with the dropped count
    # reported.
    overflow_policy: str = "exact"
    # Fused MaxSim kernel over the pinned token grid: "auto" uses it when
    # the grid is pinned on a CUDA device; "pallas" (the JAX package's
    # name, kept) forces it (for CPU tensors that is its plain PyTorch
    # version); "off" keeps the tiled scan path.
    kernel: str = "auto"
    # Grid-only refinement rerank (int8 grids loaded with
    # load_grid_only(refine=True)): the kernel returns this many candidates
    # per query, which are then re-scored EXACTLY by decompressing their
    # residual codes from the host-resident compressed arrays (reference
    # exact-rerank semantics, search.rs:460-493 — f32-true scores on top of
    # the int8 recall stage). 0 = auto (4 x top_k, min 32) when the index
    # carries refine data; -1 disables refinement.
    refine_depth: int = 0
    # Recall-targeted operating point (no reference equivalent — the
    # reference ships one fixed default, search.rs:58-69). When set, the
    # staged pipeline's (approx_score, prune_keep) pair is chosen from the
    # measured 72M-embedding frontier (docs/benchmarks/
    # megascale_codes_frontier.json) as the HIGHEST-QPS point whose
    # measured recall@10 meets the target; a target above the best staged
    # point routes to mode="exact" (always-correct exhaustive scan).
    # Explicitly-set approx_score/prune_keep/mode win over the selector.
    # The frontier was measured at 72M embeddings / nprobe=8; smaller
    # corpora only over-deliver recall, so the selection is conservative.
    # None = reference-default behavior. See also
    # `SearchParameters.preset()` for named profiles.
    target_recall: Optional[float] = None

    # Named operating-point presets over target_recall. Values are recall
    # targets into the measured frontier; "exact" pins the exhaustive path.
    PRESETS = {
        "latency": 0.92,
        "balanced": 0.97,
        "quality": 0.995,
        "exact": 1.0,
    }

    @classmethod
    def preset(cls, name: str, **overrides: Any) -> "SearchParameters":
        """Operating-point presets: 'latency' (recall >= 0.92 at max QPS),
        'balanced' (>= 0.97), 'quality' (>= 0.995), 'exact' (exhaustive).
        Points of the JAX package's TPU v5e record at 72M embeddings
        (MEASURED_FRONTIER_72M; the QPS are that TPU's, not this package's):
        latency -> cells/keep=512 (28.4 QPS @ 0.9422), balanced ->
        cells/keep=1024 (23.4 QPS @ 0.9781), quality -> codes/keep=512
        (15.8 QPS @ 0.9953)."""
        if name not in cls.PRESETS:
            raise ValueError(
                f"unknown preset {name!r}: expected one of "
                f"{sorted(cls.PRESETS)}"
            )
        return cls(target_recall=cls.PRESETS[name], **overrides)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SearchParameters":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


# (approx_score, prune_keep) -> (QPS, recall@10) frontier at 72M embeddings,
# nprobe=8, batch 64 pipelined: the JAX package's record on one TPU v5e chip
# (docs/benchmarks/megascale_codes_frontier.json), copied so that
# `resolve_target_recall` selects the same operating point in both packages.
# The QPS column is that TPU record, NOT a time of this package on a GPU: it
# only ORDERS the points (recall is a property of the algorithm). This
# package's own times on an H100 are in PERF.md. Sorted by QPS descending so
# selection is a scan.
MEASURED_FRONTIER_72M = (
    ("cells", 128, 33.87, 0.8656),
    ("cells", 256, 31.80, 0.9188),
    ("cells", 512, 28.38, 0.9422),
    ("codes", 128, 27.37, 0.9234),
    ("cells", 1024, 23.35, 0.9781),
    ("codes", 256, 22.00, 0.9719),
    ("codes", 512, 15.81, 0.9953),
    ("codes", 1024, 10.11, 0.9969),
)


def resolve_target_recall(params: "SearchParameters") -> "SearchParameters":
    """Materialize `target_recall` into concrete staged-pipeline settings.

    Picks the highest-QPS measured frontier point whose recall@10 meets the
    target; above the best staged point (0.9969) the exhaustive exact path
    is the only honest answer. Fields the caller set explicitly (non-default
    approx_score/prune_keep/mode) are respected — the selector only fills
    defaults. Returns `params` unchanged when target_recall is None.
    """
    if params.target_recall is None:
        return params
    t = float(params.target_recall)
    defaults = SearchParameters()
    # Caller overrides win: only select for fields left at their defaults,
    # and restrict the frontier to rows consistent with fixed fields (a
    # caller pinning approx_score="cells" must not get a prune_keep chosen
    # for a codes row).
    free_mode = params.mode == defaults.mode
    free_score = params.approx_score == defaults.approx_score
    free_keep = params.prune_keep == defaults.prune_keep
    best = None
    for score, keep, qps, recall in MEASURED_FRONTIER_72M:
        if not free_score and score != params.approx_score:
            continue
        if not free_keep and keep != params.prune_keep:
            continue
        if recall >= t and (best is None or qps > best[2]):
            best = (score, keep, qps, recall)
    kw: Dict[str, Any] = {}
    if best is None:
        # No staged point meets the target: exhaustive scan (recall 1.0 by
        # construction; int8 grids additionally refine — f32-true scores).
        if free_mode:
            kw["mode"] = "exact"
    else:
        if free_score:
            kw["approx_score"] = best[0]
        if free_keep:
            kw["prune_keep"] = best[1]
    if not kw:
        return params
    return dataclasses.replace(params, **kw)


@dataclass
class Metadata:
    """Index metadata.json schema (index.rs:105-127)."""

    num_chunks: int
    nbits: int
    num_partitions: int
    num_embeddings: int
    avg_doclen: float
    num_documents: int = 0
    embedding_dim: int = 0
    next_plaid_compatible: bool = True

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Metadata":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})
