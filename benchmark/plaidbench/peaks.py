"""Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, no
sparsity, at the full 700 W power limit), and the MaxSim work arithmetic.

A MaxSim pass scores every query token against every live document token:
2 * (query tokens) * (document tokens) * d operations, counted from the
tokens the inputs hold, not from the padded grid slots the kernel walks.
"""

from __future__ import annotations

PEAK_OPS_PER_S = {
    "bf16": 989e12,
    "fp16": 989e12,
    "fp8": 1979e12,
    "int8": 1979e12,
    "tf32": 495e12,
    "fp32": 67e12,
}
HBM_BYTES_PER_S = 3.35e12


def maxsim_ops(query_tokens: int, doc_tokens: int, dim: int) -> float:
    """Operations of one exact MaxSim over `query_tokens` live query tokens
    and `doc_tokens` live document tokens of width `dim`."""
    return 2.0 * float(query_tokens) * float(doc_tokens) * float(dim)


def seconds_at_peak(ops: float, dtype: str) -> float:
    """The least time the card needs for `ops` operations in `dtype`."""
    return ops / PEAK_OPS_PER_S[dtype]
