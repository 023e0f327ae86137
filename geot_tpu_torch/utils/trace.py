"""Spans and the set-up record of the program, for `torch.profiler`.

`span(name)` marks a stretch of the program (a train step's phases, a
conv, an op) with `torch.profiler.record_function(name)` while a profiler
session runs, so that the profiler can put each kernel and each idle gap
down to what the program was doing. With no session it is a shared no-op
that calls nothing in the profiler (a bare `record_function` costs
microseconds of host time a use even without one). The spans are on
exactly when a profiler is; nothing else turns them on.

`setup_phase(name)` times once-per-process set-up work (a kernel library's
build and load, the optimizer's construction) on the host clock and adds
its seconds under `name` to the process's record, which `setup_record()`
returns. The record is per process because what it times is: a library
loaded once serves every caller of the process. The graph's set-up is
timed by `Graph.build_stats`, not here.

`count(name, n)` adds n to the counter `name` of the process's counter
record, which `counter_record()` returns: counts that the program decides
once, at set-up (the hybrid plans' streamed and total edges, written where
a graph is built or loaded from the cache; `gcn.layers` and
`gcn.aggregate_first`, written where a `GCNConv` is built), never on the
step path.

Span names start with "geot.".
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator

import torch
from torch.autograd import profiler as _profiler

__all__ = ["span", "setup_phase", "setup_record", "count", "counter_record"]

_OFF = contextlib.nullcontext()
_LOCK = threading.Lock()
# phase -> host seconds
_SETUP: Dict[str, float] = {}
# counter -> count
_COUNTS: Dict[str, int] = {}


def span(name: str):
    """A context manager: `record_function(name)` while a profiler session
    runs, else a shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def setup_phase(name: str) -> Iterator[None]:
    """Adds the host seconds of the block to `name` in the process's set-up
    record, also when the block raises."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _LOCK:
            _SETUP[name] = _SETUP.get(name, 0.0) + dt


def setup_record() -> Dict[str, float]:
    """A copy of the process's set-up record: {phase: host seconds}."""
    with _LOCK:
        return dict(_SETUP)


def count(name: str, n: int) -> None:
    """Adds n to the counter `name` of the process's counter record."""
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + int(n)


def counter_record() -> Dict[str, int]:
    """A copy of the process's counter record: {counter: count}."""
    with _LOCK:
        return dict(_COUNTS)
