"""gemm_ms.<train|serve> (model layer): device milliseconds per step or
request of cuBLAS / CUTLASS matrix products in the traced stretch (the
classes in `kernel_classes.json`)."""


def read(ctx, part):
    if part != ctx.mode or ctx.trace is None:
        return None
    t = ctx.trace["by_class"].get("gemm", 0.0)
    return t / ctx.iters * 1e3 if t > 0 else None
