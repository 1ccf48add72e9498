"""Host time inside `search_batch_async` per batch, averaged over the
traced run's window: the benchmark's own span around the call (dispatch
start to return). While the dispatch waits for the card, this is most of a
batch."""


def read(ctx):
    spans = ctx.get("dispatch_s")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
