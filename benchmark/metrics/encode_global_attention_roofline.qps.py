"""The packed attention kernel's share of its roofline over global layers:
the least time the traced stretch's global attention needed (per forward,
4 x hidden x `encode.attn_pairs_global` operations at the bf16 peak, or
`encode.attn_layers_global` launches of q, k, v and output, 8 x
`encode.live_tokens` x hidden bytes, at the memory's rate, whichever is
longer; plaidbench/xlmr_work.py) over the summed device time of the kernels
named KERNEL. It needs no knowledge of the model family, but counts only
global layers: a cell whose kernel also runs local layers is not read.
Nothing off the card, when the kernel did not run, or from a program that
does not count `encode.attn_layers_global`."""

from plaidbench import encoder_work, program_trace, xlmr_work

KERNEL = "varlen_attention_kernel"  # ops/attention.py's Triton kernel


def read(ctx):
    trace, recs = ctx.get("trace"), program_trace.records(ctx)
    if not trace or not recs:
        return None
    kernel_s = sum(s for name, s in trace["device_s_by_name"].items() if KERNEL in name)
    forwards = [f for f in encoder_work.forwards_of(recs) if "encode.attn_layers_global" in f]
    if kernel_s <= 0 or not forwards:
        return None
    bound = xlmr_work.global_attention_bound_s(forwards, ctx["config"]["hidden_size"])
    return 100.0 * bound / kernel_s
