"""The whole search step's share of the card's peak: the MaxSim work of a
batch (as maxsim_roofline.qps counts it) at the peak for the grid's dtype,
over the traced window's wall time per batch read; nothing off the card. It reads the same work
whatever computes MaxSim, so it still bounds a change that takes the kernel
off the path."""

from plaidbench.peaks import seconds_at_peak


def read(ctx):
    dtype = ctx.get("grid_dtype")
    if dtype is None or not ctx.get("on_card") or not ctx.get("window_batches"):
        return None
    wall_per_batch = ctx["window_s"] / ctx["window_batches"]
    return 100.0 * seconds_at_peak(ctx["ops_per_batch"], dtype) / wall_per_batch
