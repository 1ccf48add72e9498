"""The MaxSim kernels' share of their roofline: the work the profiled
batches needed (2 x query tokens x live document tokens x d, from the
inputs' shapes) at the card's peak for the grid's dtype, over the summed
device time of the kernels whose names hold an entry of KERNELS. Nothing
off the card, when the cell scores no pinned grid, or when no such kernel
ran."""

from plaidbench.peaks import seconds_at_peak

# Device names of the served MaxSim kernels: both grids' kernels are
# instances of csrc/maxsim_wgmma.cuh's `maxsim_kernel` template.
KERNELS = ("maxsim_kernel",)


def read(ctx):
    trace, dtype = ctx.get("trace"), ctx.get("grid_dtype")
    if not trace or dtype is None or not ctx.get("on_card") or not ctx.get("trace_batches"):
        return None
    kernel_s = sum(
        s for name, s in trace["device_s_by_name"].items()
        if any(k in name for k in KERNELS)
    )
    if kernel_s <= 0:
        return None
    ops = ctx["ops_per_batch"] * ctx["trace_batches"]
    return 100.0 * seconds_at_peak(ops, dtype) / kernel_s
