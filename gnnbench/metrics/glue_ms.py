"""glue_ms.<train|serve> (op + autograd layer): device milliseconds per
step or request of kernels that are neither the program's own nor matrix
products (the softmax's reductions, the remainder's accumulate, norms,
activations, dropout, the loss, the optimizer)."""


def read(ctx, part):
    if part != ctx.mode or ctx.trace is None:
        return None
    t = ctx.trace["by_class"].get("glue", 0.0)
    return t / ctx.iters * 1e3 if t > 0 else None
