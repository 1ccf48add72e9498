"""The whole rerank step's share of the card's bf16 peak: the model
operations of the requests read in the timed window (both forwards' dense
products, projections and attention pairs, and the MaxSim scoring, from
their token counts; plaidbench/encoder_work.py) at 989 TFLOP/s, over the
window's wall time. It counts the same work whatever computes it."""

from plaidbench.peaks import seconds_at_peak


def read(ctx):
    if not ctx.get("on_card") or not ctx.get("window_ops"):
        return None
    return 100.0 * seconds_at_peak(ctx["window_ops"], "bf16") / ctx["window_s"]
