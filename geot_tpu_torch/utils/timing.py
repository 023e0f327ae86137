"""Timing of a callable on the card.

Port of `geot_tpu/utils/timing.py` (`timeit`): warm-up calls, then the
mean over `iters` calls between two CUDA events on the current stream
(the reference times TPU calls on the host clock around a device fence).
The device is resolved as every entry point's is (`resolve_device`): the
card unless the caller asks for the CPU, whose calls are timed on the host
clock with `time.perf_counter`.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from geot_tpu_torch.utils.device import resolve_device

__all__ = ["timeit"]


def timeit(fn: Callable, *args, warmup: int = 10, iters: int = 100,
           device: Optional[torch.device] = None) -> float:
    """Mean seconds per call of `fn(*args)`. On a CUDA `device` (the
    default; it raises without one) the calls are timed by CUDA events
    recorded before the first and after the last, after `warmup` calls and
    a synchronize; on an explicit CPU device by the host clock."""
    dev = resolve_device(device)
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
