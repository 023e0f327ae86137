"""device_busy_ms.<train|serve> (device layer): milliseconds per step or
request in which some operation ran on the card, from the union of the
device's activity intervals over the traced stretch. In an open loop the
idle share is one minus the offered load, so a faster forward would read
as more idle; the busy time per request falls with it instead."""


def read(ctx, part):
    if part != ctx.mode or ctx.trace is None or ctx.trace["busy_s"] <= 0:
        return None
    return ctx.trace["busy_s"] / ctx.iters * 1e3
