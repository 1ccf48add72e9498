"""Host time the encoder spends tokenizing and packing per rerank
request: the program's host spans `encode.prepare`, summed over a request
and averaged over the requests of the traced stretch."""

from plaidbench import program_trace
from plaidbench.encoder_work import request_mean


def read(ctx):
    recs = program_trace.records(ctx)
    return request_mean(recs, "span", "encode.prepare") if recs else None
