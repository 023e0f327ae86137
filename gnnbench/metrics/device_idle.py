"""device_idle.<train|serve> (device layer): the share of the traced
window in which no operation ran on the card, from the union of the
device's activity intervals (overlapping operations counted once). For a
closed loop: in an open loop it is one minus the offered load
(`device_busy_ms` reads the device there)."""


def read(ctx, part):
    if part != ctx.mode or ctx.trace is None or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
