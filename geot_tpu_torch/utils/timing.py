"""Timing of a callable on the card.

Port of `geot_tpu/utils/timing.py` (`timeit`): warm-up calls, then the
mean over `iters` calls between two CUDA events on the current stream
(the reference times TPU calls on the host clock around a device fence).
CPU callables are timed on the host clock with `time.perf_counter`.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

__all__ = ["timeit"]


def timeit(fn: Callable, *args, warmup: int = 10, iters: int = 100,
           device: Optional[torch.device] = None) -> float:
    """Mean seconds per call of `fn(*args)`. On a CUDA `device` (default:
    the card where CUDA is available) the calls are timed by CUDA events
    recorded before the first and after the last, after `warmup` calls and
    a synchronize; on the CPU by the host clock."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    for _ in range(warmup):
        fn(*args)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    with torch.cuda.device(dev):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
