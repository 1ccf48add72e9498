"""Staged stages 1-3b (centroid scores, cell selection, the prune and the
union): the port's CUDA-event marks from `start` to `union`, per batch,
averaged over the traced run's marked batches."""


def read(ctx):
    spans = [m["union"] - m["start"] for m in ctx.get("marks", [])
             if "union" in m and "start" in m]
    return sum(spans) / len(spans) if spans else None
