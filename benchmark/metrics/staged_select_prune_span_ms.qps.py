"""Staged stages 1-3b on the served path: the program's device span
`staged.select_prune` (its CUDA-event marks `start` to `union` in the
batches `search_batch_async` dispatched inside the traced stretch), per
batch."""

from plaidbench import program_trace


def read(ctx):
    return program_trace.batch_mean(program_trace.records(ctx), "device", "staged.select_prune")
