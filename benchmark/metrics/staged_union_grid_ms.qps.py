"""Staged stage 4's grid build (`index/search.py:_build_union_grid`): the
port's CUDA-event marks from `union` to `stage4_grid`, per batch, averaged
over the traced run's marked batches."""


def read(ctx):
    spans = [m["stage4_grid"] - m["union"] for m in ctx.get("marks", [])
             if "stage4_grid" in m and "union" in m]
    return sum(spans) / len(spans) if spans else None
