"""Host time in `search.result.build` per batch, less its child spans (a
fallback search's own): the overflow check and the Python loop that builds
the batch's QueryResults, while nothing of this batch is left on the card."""

from plaidbench import program_trace


def read(ctx):
    recs = program_trace.records(ctx)
    if not recs:
        return None
    return program_trace.batch_mean(recs, "span", "search.result.build", program_trace.self_ms(recs))
