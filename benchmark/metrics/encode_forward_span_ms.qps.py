"""Device time of the encoder's forwards per rerank request: the program's
device spans `encode.forward` (CUDA events around each forward, the query's
and the documents'), summed over a request and averaged over the requests
of the traced stretch."""

from plaidbench import program_trace
from plaidbench.encoder_work import request_mean


def read(ctx):
    recs = program_trace.records(ctx)
    return request_mean(recs, "device", "encode.forward") if recs else None
