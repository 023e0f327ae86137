"""stream_edge_share (graph layer): the percentage of the hybrid plans'
edges, forward and transpose together, that the cell census streams, from
the program's counter record (`geot_tpu_torch.utils.trace.counter_record`,
written where a graph's hybrid plans are built or loaded). The record is
the process's, so it is read here, after the run. None where the program
keeps no counter record or built no hybrid plans."""

DIRECTIONS = ("forward", "transpose")


def counter_record():
    """The program's counter record {counter: count}, or None."""
    try:
        from geot_tpu_torch.utils.trace import counter_record as record
    except ImportError:
        return None
    return record()


def read(ctx, part):
    rec = counter_record()
    if rec is None:
        return None
    streamed = sum(rec.get(f"stream.{d}.streamed_edges", 0) for d in DIRECTIONS)
    total = sum(rec.get(f"stream.{d}.edges", 0) for d in DIRECTIONS)
    return 100.0 * streamed / total if total > 0 else None
