"""Run a function on several ranks of a `torch.distributed` group, one
spawned process each, on one machine.

    results = spawn_ranks(fn, world_size, *args, backend="gloo")

Each process sets one thread, joins a group through a rendezvous file in
a fresh temporary directory (no port to find), calls fn(rank, world_size,
*args) and hands back its picklable result (numpy arrays, numbers); the
list comes back in rank order. A failure on any rank, or a rank still
running at `timeout`, kills every process and raises: a collective that
deadlocks fails after the group's timeout (`GROUP_TIMEOUT_S`) or at
`timeout`. `fn`
must be importable by name (a module-level function) and must not import
JAX: the children import its module afresh.

On a machine with several cards, `torchrun --nproc-per-node N script.py`
starts the ranks instead (`dist.init_process_group("nccl")` then reads
the rank and world size from the environment).
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

__all__ = ["spawn_ranks"]

GROUP_TIMEOUT_S = 60.0  # a group's rendezvous and each collective give up after this


def _rank_main(fn, rank, world_size, backend, init_method, results, args):
    torch.set_num_threads(1)
    try:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn_ranks(fn, world_size: int, *args, backend: str = "gloo",
                timeout: float = 300.0) -> list:
    """fn(rank, world_size, *args) on `world_size` spawned ranks of one
    group; their results in rank order. Raises RuntimeError with the
    first failing rank's traceback, or TimeoutError past `timeout`
    seconds; no process outlives the call."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="geot_ranks_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, backend, init_method, results, args))
             for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        got = {}
        deadline = time.monotonic() + timeout
        while len(got) < world_size:
            left = deadline - time.monotonic()
            try:
                rank, ok, out = results.get(timeout=max(min(left, 5.0), 0.01))
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank exited with code {dead[0]} before its result")
                if left <= 0:
                    raise TimeoutError(f"{world_size - len(got)} of {world_size} ranks still "
                                       f"running after {timeout:.0f}s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=30)
        return [got[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
