"""stream_ms.<train|serve> (kernels layer): device milliseconds per step or
request of the hybrid route's streamed cells, the stream kernels
(`stream_row_kernel`, `stream_fix_kernel`), from the traced stretch's
device time by name. Nothing to read where no stream kernel ran."""

KERNELS = ("stream_row_kernel", "stream_fix_kernel")


def kernel_ms(ctx, part, kernels):
    """Device ms per iteration of the kernels whose names hold one of
    `kernels`, or None."""
    if part != ctx.mode or ctx.trace is None or not ctx.iters:
        return None
    t = sum(v for k, v in ctx.trace["by_name"].items() if any(p in k for p in kernels))
    return t / ctx.iters * 1e3 if t > 0 else None


def read(ctx, part):
    return kernel_ms(ctx, part, KERNELS)
