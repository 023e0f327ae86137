"""step_mfu.<train|serve> (whole step): the least time of every operation
the configuration lists for the step or request (each the larger of its
flops at the card's peak for its precision and its bytes at the memory
rate) over the measured time per step or request of the untraced window."""

from gnnbench.harness.costs import least_time


def read(ctx, part):
    if part != ctx.mode or ctx.peaks is None or ctx.per_iter_s <= 0:
        return None
    least = least_time(ctx.ops, ctx.mode, ctx.dims, ctx.peaks, ctx.matmul_flops)
    return 100.0 * least / ctx.per_iter_s
