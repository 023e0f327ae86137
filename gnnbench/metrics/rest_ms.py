"""rest_ms.<train|serve> (kernels layer): device milliseconds per step or
request of the edge-row kernel and its fix-up (`edge_row_kernel`,
`edge_fix_kernel`), from the traced stretch's device time by name: on a
hybrid graph the BAT remainder of the hybrid route. Nothing to read where
neither ran."""

from gnnbench.metrics.stream_ms import kernel_ms

KERNELS = ("edge_row_kernel", "edge_fix_kernel")


def read(ctx, part):
    return kernel_ms(ctx, part, KERNELS)
