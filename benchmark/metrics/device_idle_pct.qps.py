"""Share of the profiled stretch of the traced run in which no operation
ran on the card (torch.profiler's device intervals, merged)."""


def read(ctx):
    trace = ctx.get("trace")
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
