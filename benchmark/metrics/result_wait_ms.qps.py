"""Host time in `search.result.wait` per batch: the program's own span
around the copy of a batch's ids and scores back to the host, which waits
for everything queued before it on the stream (with two batches in
flight, the next batch's kernels too)."""

from plaidbench import program_trace


def read(ctx):
    return program_trace.batch_mean(program_trace.records(ctx), "span", "search.result.wait")
