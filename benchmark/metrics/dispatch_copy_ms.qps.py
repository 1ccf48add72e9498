"""Host time in `search.dispatch.copy` per batch: the program's own span
around the copy of the queries, their mask and any subset mask to the card
(a blocking copy from pageable memory, which waits behind the work queued
on the stream)."""

from plaidbench import program_trace


def read(ctx):
    return program_trace.batch_mean(program_trace.records(ctx), "span", "search.dispatch.copy")
