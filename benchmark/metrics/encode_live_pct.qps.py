"""Share of the encoder's token slots that hold a live token: 100 x the
program's counters `encode.live_tokens` / `encode.token_slots`, summed over
the forwards of the traced stretch. A padded forward computes every slot;
a packed one only live tokens."""

from plaidbench import program_trace


def read(ctx):
    recs = program_trace.records(ctx) or []
    live = sum(r.value for r in recs if r.kind == "count" and r.name == "encode.live_tokens")
    slots = sum(r.value for r in recs if r.kind == "count" and r.name == "encode.token_slots")
    return 100.0 * live / slots if slots > 0 else None
