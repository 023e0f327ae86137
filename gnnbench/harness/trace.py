"""Reduce a `torch.profiler` trace of the traced stretch to what the
per-layer metrics read: device time by kernel class and by name, the
union of device activity against the traced window, launches, and the
idle gaps named by the host operation running in them.

The traced stretch runs inside a `record_function(WINDOW)` span that
ends with a synchronize, so its host interval covers all the device work
it started; device and host events share the profiler's clock.
"""

from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict
from typing import Dict, List

from gnnbench.harness.stats import gaps, union_length

__all__ = ["WINDOW", "classify", "load_classes", "reduce_events", "events_of"]

WINDOW = "gnnbench.traced_window"
CLASSES_FILE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "kernel_classes.json")
# gaps named by the host op under them, longest first (the rest are summed unnamed)
_NAMED_GAPS = 4000


def load_classes(path: str = CLASSES_FILE) -> Dict[str, List[str]]:
    with open(path) as fh:
        table = json.load(fh)
    return {k: [s.lower() for s in v] for k, v in table.items() if isinstance(v, list)}


def classify(name: str, classes: Dict[str, List[str]]) -> str:
    """"own", "gemm", "copy" (the first whose pattern is in the name) or
    "glue"."""
    low = name.lower()
    for cls in ("own", "gemm", "copy"):
        if any(p in low for p in classes.get(cls, ())):
            return cls
    return "glue"


def _innermost(starts, cpu, t: float) -> str:
    """Name of the host op with the latest start that still runs at t."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 5000, -1), -1):
        s, e, name = cpu[j]
        if e >= t:
            return name
    return "(no host op)"


def reduce_events(device: List[tuple], host: List[tuple], window: tuple,
                  classes: Dict[str, List[str]]) -> Dict:
    """device: (name, start_us, end_us) of each device operation; host:
    (name, start_us, end_us) of each host op; window: (start_us, end_us).
    Returns seconds by class and by name, busy seconds (the union of device
    activity in the window), the window's seconds, the kernel count
    (copies excluded) and the idle seconds by host op, longest first."""
    lo, hi = window
    by_class: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    ivs, kernels = [], 0
    for name, s, e in device:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        cls = classify(name, classes)
        by_class[cls] += (e - s) * 1e-6
        by_name[name] += (e - s) * 1e-6
        kernels += cls != "copy"
        ivs.append((s, e))
    busy = union_length(ivs, lo, hi) * 1e-6
    cpu = sorted((s, e, n) for n, s, e in host if n != WINDOW and e > s)
    starts = [c[0] for c in cpu]
    idle: Dict[str, float] = defaultdict(float)
    holes = sorted(gaps(ivs, lo, hi), key=lambda g: g[0] - g[1])
    for s, e in holes[:_NAMED_GAPS]:
        idle[_innermost(starts, cpu, (s + e) / 2)] += (e - s) * 1e-6
    rest = sum(e - s for s, e in holes[_NAMED_GAPS:]) * 1e-6
    if rest:
        idle["(shorter gaps)"] += rest
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": busy,
        "by_class": dict(by_class),
        "by_name": dict(by_name),
        "kernels": kernels,
        "idle_by_host_op": sorted(idle.items(), key=lambda kv: -kv[1]),
    }


def events_of(prof) -> tuple:
    """(device, host, window) lists of a finished `torch.profiler.profile`."""
    import torch

    device, host, window = [], [], None
    for ev in prof.events():
        tr = ev.time_range
        row = (ev.name, float(tr.start), float(tr.end))
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            # the window's own annotation is mirrored on the device timeline
            if ev.name != WINDOW and not getattr(ev, "is_user_annotation", False):
                device.append(row)
        else:
            host.append(row)
            if ev.name == WINDOW:
                window = (row[1], row[2])
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW!r} span")
    return device, host, window
