"""Device time by the program's own spans, forward and backward, from the
traced stretch's profile: `reduce_spans(prof, window, classes)` takes the
finished profile and the window that `cell._trace` reads with `events_of`.
The cell's traced run does not call it yet, so no metric reads it.

The program marks its layers with `record_function` spans named "geot.*"
while a profiler runs (`geot_tpu_torch.utils.trace`): the train step's
phases, each conv, the norm and dropout, and the ops (the GAT logits, the
softmax, mh, each SpMM route). Each device event that `events_of` keeps
(the window's and the spans' own annotations left out) is put down to one
span:

1. its launch: the host op whose correlation id the event links to (the
   link the profiler fills each op's `kernels` from);
2. that op and its parents, innermost first, up to the first "geot." span:
   work of that span, backward if the walk passed an autograd node;
3. if the walk first meets an autograd node with a sequence number N >= 0
   (`autograd::engine::evaluate_function: ...`), backward work of the
   forward op that made the node: the op with sequence number N on the
   node's forward thread, the last to start before the node ran, and its
   innermost "geot." span;
4. else the innermost "geot.train.*" span that holds the launch in time
   (gradient accumulation, whose node has no sequence number, on the
   backward thread);
5. else `NO_SPAN`.

Each event's interval is clipped to the traced window as `reduce_events`
clips it, so the spans' seconds sum to the trace's device seconds.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

from gnnbench.harness.trace import WINDOW, classify

__all__ = ["NO_SPAN", "PREFIX", "Attribution", "span_table", "reduce_spans", "format_spans"]

NO_SPAN = "(no program span)"
PREFIX = "geot."
_PHASE = "geot.train."
_NODE = "autograd::engine::evaluate_function: "


def _span_above(op) -> Tuple[Optional[str], Optional[object]]:
    """(the innermost "geot." span at or above `op`, or None; the autograd
    node the walk met, or None). The walk stops at a node with a sequence
    number; one without (gradient accumulation) only marks the work as
    backward."""
    node = None
    while op is not None:
        if op.name.startswith(PREFIX):
            return op.name, node
        if op.name.startswith(_NODE):
            node = op
            if op.sequence_nr >= 0:
                return None, node
        op = op.cpu_parent
    return None, node


class Attribution:
    """Puts host ops down to spans (the rule of the module's docstring)
    over a profile's host events, each with `id`, `name`, `thread`,
    `fwd_thread`, `sequence_nr`, `cpu_parent`, `time_range` and `kernels`
    as `torch.profiler`'s events have them."""

    def __init__(self, host: Iterable):
        # ops that launched device work, by correlation id (a runtime call's
        # own id can take the same number, but it holds no kernels)
        self.by_id: Dict[int, object] = {}
        # (thread, sequence number) -> [(start, op)], by start
        self.by_seq: Dict[Tuple[int, int], List] = defaultdict(list)
        self.phases = []  # (start, end, name) of the geot.train.* spans
        for ev in host:
            if ev.kernels:
                self.by_id[ev.id] = ev
            if ev.sequence_nr >= 0 and not ev.name.startswith(_NODE):
                self.by_seq[(ev.thread, ev.sequence_nr)].append((ev.time_range.start, ev))
            if ev.name.startswith(_PHASE):
                self.phases.append((ev.time_range.start, ev.time_range.end, ev.name))
        for ops in self.by_seq.values():
            ops.sort(key=lambda t: t[0])

    def launch(self, link: int):
        """The host op of correlation id `link`, or None."""
        return self.by_id.get(link)

    def forward_op(self, node):
        """The forward op that made the autograd node `node`."""
        ops = self.by_seq.get((node.fwd_thread, node.sequence_nr))
        if not ops:
            return None
        i = bisect.bisect_left(ops, node.time_range.start, key=lambda t: t[0]) - 1
        return ops[i][1] if i >= 0 else None

    def phase_at(self, t: float) -> Optional[str]:
        """The innermost geot.train.* span that holds time t (the latest
        to start of those that do)."""
        held = [(s, name) for s, e, name in self.phases if s <= t <= e]
        return max(held)[1] if held else None

    def span_of(self, op) -> Tuple[str, str]:
        """(span, "forward" or "backward") of the work that host op `op` did."""
        name, node = _span_above(op)
        way = "forward" if node is None else "backward"
        if name is not None:
            return name, way
        if node is not None and node.sequence_nr >= 0:
            fwd = self.forward_op(node)
            if fwd is not None:
                name, _ = _span_above(fwd)
                if name is not None:
                    return name, way
        name = self.phase_at(op.time_range.start)
        return (name if name is not None else NO_SPAN), way


def span_table(device: Iterable[Tuple[str, float, float, int]], host: Iterable,
               window: Tuple[float, float], classes: Dict[str, List[str]]) -> Dict:
    """device: (name, start_us, end_us, correlation id of the launching
    host op) of each device event `events_of` keeps; host: the host events.
    Returns {"by_span": {span: {"forward" | "backward": [seconds, kernels]}},
    "device_s": the seconds of all of them}, each interval clipped to the
    window and kernels counted as `reduce_events` counts them (copies left
    out)."""
    att = Attribution(host)
    lo, hi = window
    by_span: Dict[str, Dict[str, List]] = defaultdict(lambda: {"forward": [0.0, 0],
                                                               "backward": [0.0, 0]})
    total = 0.0
    for name, s, e, link in device:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        op = att.launch(link)
        span, way = att.span_of(op) if op is not None else (NO_SPAN, "forward")
        cell = by_span[span][way]
        cell[0] += (e - s) * 1e-6
        cell[1] += classify(name, classes) != "copy"
        total += (e - s) * 1e-6
    return {"by_span": dict(by_span), "device_s": total}


def reduce_spans(prof, window: Tuple[float, float], classes: Dict[str, List[str]]) -> Dict:
    """`span_table` of a finished `torch.profiler.profile`: its device
    events as `events_of` keeps them, each with the correlation id of the
    host op it links to (read from the profiler's results: not every torch
    version puts it on the events), and its host events."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    links = {k.correlation_id(): k.linked_correlation_id()
             for k in prof.profiler.kineto_results.events() if k.device_type() == cuda}
    device, host = [], []
    for ev in prof.events():
        if ev.device_type == cuda:
            if ev.name != WINDOW and not getattr(ev, "is_user_annotation", False):
                device.append((ev.name, ev.time_range.start, ev.time_range.end,
                               links.get(ev.id, 0)))
        else:
            host.append(ev)
    return span_table(device, host, window, classes)


def format_spans(spans: Dict, iters: int) -> str:
    """One line: each span's device ms and kernels per iteration, forward /
    backward, longest first, then the sum against the trace's."""
    rows = sorted(spans["by_span"].items(),
                  key=lambda kv: -(kv[1]["forward"][0] + kv[1]["backward"][0]))
    parts = []
    for name, c in rows:
        f, b = c["forward"], c["backward"]
        parts.append(f"{name} {f[0] / iters * 1e3:.4f} ms {f[1] / iters:.1f} k / "
                     f"{b[0] / iters * 1e3:.4f} ms {b[1] / iters:.1f} k")
    parts.append(f"device {spans['device_s'] / iters * 1e3:.4f} ms")
    return "; ".join(parts)
