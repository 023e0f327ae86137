"""client_late_ms.serve (client layer): the 99th percentile over the
window's requests of how late the open loop's generator sent a request
past the later of its due time and the previous request's completion, in
milliseconds: the harness's own delay, apart from the queue's wait, which
the latency counts. Nothing to read in a closed loop."""


def read(ctx, part):
    if part != ctx.mode or ctx.late_ms is None:
        return None
    return ctx.late_ms
