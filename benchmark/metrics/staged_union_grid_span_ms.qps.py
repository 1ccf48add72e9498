"""Staged stage 4's union grid build on the served path: the program's
device span `staged.union_grid` (marks `union` to `stage4_grid` in the
batches dispatched inside the traced stretch), per batch."""

from plaidbench import program_trace


def read(ctx):
    return program_trace.batch_mean(program_trace.records(ctx), "device", "staged.union_grid")
