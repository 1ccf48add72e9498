"""Seconds of the build's k-means phase: the program's set-up span
`build.kmeans`, from the build's report of the stage to its report of the
next (after the centroids came back from the card)."""

from plaidbench import program_trace


def read(ctx):
    ms = program_trace.last_setup_span(program_trace.records(ctx), "build.kmeans")
    return None if ms is None else ms / 1e3
