"""spmm_roofline.<train|serve> (kernels layer): the least time of the
step's or request's aggregations and per-edge dots (the configuration's
`spmm` and `sddmm` operations, each input once, each output once, at the
card's memory rate) over the device time of the program's own kernels."""

from gnnbench.harness.costs import least_time


def read(ctx, part):
    if part != ctx.mode or ctx.trace is None or ctx.peaks is None:
        return None
    own = ctx.trace["by_class"].get("own", 0.0) / ctx.iters
    if own <= 0:
        return None
    least = least_time(ctx.ops, ctx.mode, ctx.dims, ctx.peaks, ctx.matmul_flops,
                       kinds=("spmm", "sddmm"))
    return 100.0 * least / own
