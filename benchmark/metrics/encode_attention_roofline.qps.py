"""The packed attention kernel's share of its roofline: the least time the
traced stretch's attention needed (per layer launch, its operations from
the program's `encode.attn_pairs_*` counters at the bf16 peak or its bytes
of q, k, v and output at the memory's rate, whichever is longer;
plaidbench/encoder_work.py) over the summed device time of the kernels
named KERNEL. Nothing off the card or when the kernel did not run."""

from plaidbench import encoder_work, program_trace

KERNEL = "varlen_attention_kernel"  # ops/attention.py's Triton kernel


def read(ctx):
    trace, recs = ctx.get("trace"), program_trace.records(ctx)
    if not trace or not recs:
        return None
    kernel_s = sum(s for name, s in trace["device_s_by_name"].items() if KERNEL in name)
    forwards = [f for f in encoder_work.forwards_of(recs) if "encode.attn_pairs_global" in f]
    if kernel_s <= 0 or not forwards:
        return None
    return 100.0 * encoder_work.attention_bound_s(forwards, ctx["config"]) / kernel_s
