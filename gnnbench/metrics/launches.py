"""launches.<train|serve> (device layer): device kernels per step or
request in the traced stretch (copies and fills not counted)."""


def read(ctx, part):
    if part != ctx.mode or ctx.trace is None or not ctx.trace["kernels"]:
        return None
    return ctx.trace["kernels"] / ctx.iters
