"""Retrieval-quality evaluation: IR metrics + BEIR-format dataset loading.

Counterpart of next-plaid's quality harness
(docs/benchmarks/benchmark_scifact_docker.py:222-293, which delegates to the
external `beir` and `ranx` packages); the loader and the metric math are
written from scratch, with no dependency beyond the standard library.

A copy of `nextplaid_tpu.eval` (which imports no jax, but the port imports
nothing of the JAX package); tests/test_torch_eval.py holds the two equal.
"""

from .beir import load_beir, make_synthetic_beir
from .metrics import evaluate, ndcg_at_k, average_precision, recall_at_k

__all__ = [
    "load_beir",
    "make_synthetic_beir",
    "evaluate",
    "ndcg_at_k",
    "average_precision",
    "recall_at_k",
]
