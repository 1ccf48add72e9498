"""The program's own trace (`nextplaid_tpu_torch.utils.trace`), read by
the per-layer metrics of `benchmark/metrics/` after a traced run. The
traced stretch runs inside the harness's torch.profiler session, which
turns the program's tracer on; the untraced window and the warm-up record
nothing but set-up phases, which the program records always.

Per-batch values are means over the batches whose read (`search.result`)
was recorded. Every reader gets None off the card (the harness's CPU
rehearsals: a CPU run's times are no card's) and from a program that has
no tracer."""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Optional


def records(ctx) -> Optional[list]:
    if not ctx.get("on_card"):
        return None
    try:
        from nextplaid_tpu_torch.utils.trace import records as traced
    except ImportError:
        return None
    return traced()


def batch_mean(recs: Optional[list], kind: str, name: str,
               value: Optional[Callable] = None) -> Optional[float]:
    """Mean over the batches read of the batch's `name` records of `kind`
    (summed within a batch); `value(record)` in place of its value."""
    if not recs:
        return None
    read = {r.batch for r in recs if r.kind == "span" and r.name == "search.result"}
    per: Dict[int, float] = defaultdict(float)
    for r in recs:
        if r.kind == kind and r.name == name and r.batch in read:
            per[r.batch] += r.value if value is None else value(r)
    return sum(per.values()) / len(per) if per else None


def self_ms(recs: List) -> Callable:
    """A span's own time: its ms less its child spans' ms."""
    children: Dict[int, float] = defaultdict(float)
    for r in recs:
        if r.kind == "span" and r.parent is not None:
            children[r.parent] += r.value
    return lambda r: r.value - children.get(r.id, 0.0)


def per_batch_counts(recs: Optional[list]) -> Dict[int, Dict[str, float]]:
    """{batch: {counter: value}} of the batches read."""
    if not recs:
        return {}
    read = {r.batch for r in recs if r.kind == "span" and r.name == "search.result"}
    out: Dict[int, Dict[str, float]] = defaultdict(dict)
    for r in recs:
        if r.kind == "count" and r.batch in read:
            out[r.batch][r.name] = r.value
    return out


def last_setup_span(recs: Optional[list], name: str) -> Optional[float]:
    """The latest set-up span `name`, in ms."""
    found = [r.value for r in recs or () if r.kind == "span" and r.setup and r.name == name]
    return found[-1] if found else None
