"""Share of the staged union grid's token slots that hold a live token:
100 x `staged.union_live_tokens` / `staged.union_token_slots`, the
program's counters of each batch, averaged over the batches read. The
grid build gathers every slot, so this is the share of its work that
scores a document."""

from plaidbench import program_trace


def read(ctx):
    shares = [
        100.0 * c["staged.union_live_tokens"] / c["staged.union_token_slots"]
        for c in program_trace.per_batch_counts(program_trace.records(ctx)).values()
        if c.get("staged.union_token_slots") and "staged.union_live_tokens" in c
    ]
    return sum(shares) / len(shares) if shares else None
