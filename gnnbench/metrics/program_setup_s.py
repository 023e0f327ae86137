"""program_setup_s (set-up layer): host seconds of the program's own
set-up in this run: the graph's plans as `plan_build_s` reads them
(`Graph.build_stats`), plus the phases of the program's set-up record
(`geot_tpu_torch.utils.trace.setup_record`) "kernels" (each kernel
library's build and load) and "optimizer" (its construction). The record
is the process's, so it is read here, after the run. None where the
program keeps no set-up record."""

PHASES = ("kernels", "optimizer")


def setup_record():
    """The program's set-up record {phase: host seconds}, or None."""
    try:
        from geot_tpu_torch.utils.trace import setup_record as record
    except ImportError:
        return None
    return record()


def read(ctx, part):
    rec = setup_record()
    if rec is None:
        return None
    return ctx.plan_s + sum(rec.get(k, 0.0) for k in PHASES)
