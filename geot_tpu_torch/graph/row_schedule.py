"""The row-ordered schedule of the port's row-sum kernels, host side.

Two CUDA kernels sum by output row: the stream kernel
(`ops/csrc/stream_segment.cu`, its schedule `stream_plan.kernel_schedule`)
and the edge-row kernel (`ops/csrc/edge_row_sum.cu`, behind
`plan_segment_sum_sr2`, `plan_segment_sum_packed2`,
`plan_segment_sum_sr_packed`, `bat_segment_sum` and
`bat_segment_sum_packed`). Both take the same work list, made here once
per plan: entries in output-row order, each carrying a payload (an x row,
or an edge id) with bit 31 marking the last entry of its unit; a unit is
one row's entries, or, for a row with more than `slice_slots` of them (a
hub), one near-equal slice; a fix-up tree adds a hub row's slice partials,
at most `fix_fanin` at a time; a task is a run of consecutive elements
(units and the empty rows between them) cut at `task_cost` of work.

`RowSchedule` carries the edge-row kernel's list on a `SegmentPlan` or a
`BatPlan` (`plan.row_sched`), built from the plan's own dst-sorted arrays
(`slot_plan_entries`, `bat_plan_entries`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

__all__ = [
    "LAST_SLOT",
    "UNIT_COST",
    "ZERO_COST",
    "EDGE_SLICE",
    "EDGE_FANIN",
    "EDGE_TASK_COST",
    "row_schedule",
    "RowSchedule",
    "slot_plan_entries",
    "bat_plan_entries",
    "build_row_schedule",
]

# bit 31 of a `cols` entry marks the last entry of its unit
LAST_SLOT = 1 << 31
# a task's cost: an entry costs 1, a unit UNIT_COST more (its index, its
# flush, its store), and an empty row ZERO_COST (the zeros written there)
UNIT_COST = 8
ZERO_COST = 2
# the edge-row kernel's knobs. A task is one group's serial chain of
# loads, so short tasks and slices put more of them in flight: with tasks
# and slices of 32 the 16 timed sums of `python -m geot_tpu_torch.probe_slot
# rowsum` (the flickr AEB and the GIN / APPNP packed BAT shapes, both
# forms) took 1.2165 ms in all, with the stream kernel's 128 1.8633 ms
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6). The wide plans want
# the same: `rowsum --wide --products` summed 1.4223 / 1.9102 / 12.9459 ms
# (narrow / wide BAT and sr_packed / the products remainder) at 32, 1.5542
# / 1.9449 / 12.8378 at 64 and 1.4129 / 2.0841 / 15.2530 at 16, so one
# value serves every plan class. The fan-in is the stream kernel's.
EDGE_SLICE = 32
EDGE_FANIN = 32
EDGE_TASK_COST = 32


def _cdiv(a, b):
    return -(-a // b)


def _fix_tree(split_rows: np.ndarray, n_slices: np.ndarray, fanin: int):
    """The fix-up entries that add each split row's slice partials (row i
    owns the next n_slices[i] partials, numbered from 0 in row order) into
    the row, at most `fanin` at a time: a row with more partials than that
    is added in groups of `fanin` into partials of the next level, until
    one entry finishes it. Returns (fix [M, 3], level bounds, P)."""
    first = np.cumsum(n_slices) - n_slices
    rows, a, m = split_rows.astype(np.int64), first.astype(np.int64), n_slices.astype(np.int64)
    n_parts = int(n_slices.sum())
    levels, out = [0], []
    while len(rows):
        done = m <= fanin
        fin = np.stack([rows[done], a[done], a[done] + m[done]], axis=1)
        g = _cdiv(m[~done], fanin)  # the open rows' groups at this level
        k = np.arange(int(g.sum())) - np.repeat(np.cumsum(g) - g, g)
        p0 = np.repeat(a[~done], g) + k * fanin
        p1 = np.minimum(p0 + fanin, np.repeat(a[~done] + m[~done], g))
        new = n_parts + np.arange(len(p0))
        out += [fin, np.stack([-(new + 1), p0, p1], axis=1)]
        levels.append(levels[-1] + len(fin) + len(p0))
        rows, a, m = rows[~done], n_parts + np.cumsum(g) - g, g
        n_parts += len(p0)
    fix = np.concatenate(out) if out else np.zeros((0, 3), np.int64)
    return fix.astype(np.int32).reshape(-1, 3), tuple(levels), n_parts


def row_schedule(row: np.ndarray, cols: np.ndarray, n_out: int, *, slice_slots: int,
                 fix_fanin: int, task_cost: int) -> dict:
    """A row kernel's work over S entries in output-row order: `row` [S]
    their output rows (non-decreasing, in [0, n_out)), `cols` [S] their
    payloads (below 2**31). Returns {"cols" (int32, bit 31 set on the last
    entry of each unit), "unit_dest", "tasks", "zero_runs", "fix",
    "fix_levels", "n_parts"}: a row of n > slice_slots entries is cut into
    ceil(n / slice_slots) slices of near-equal length, each written to a
    partial; every row of [0, n_out) is in exactly one task, as a unit or
    as an empty row."""
    row = np.asarray(row, np.int64)
    cols = np.array(cols, np.int64)
    S = len(row)
    if S and (int(cols.max()) >= LAST_SLOT or n_out > LAST_SLOT):
        raise ValueError("x rows and output rows must stay below 2**31")

    # each live row's units: the whole row, or near-equal slices
    head = np.flatnonzero(np.diff(row)) + 1 if S else np.zeros(0, np.int64)
    r_start = np.concatenate([[0], head]).astype(np.int64) if S else np.zeros(0, np.int64)
    live = row[r_start]
    cnt = np.diff(np.append(r_start, S))
    k = _cdiv(cnt, slice_slots)
    U = int(k.sum())
    i_in = np.arange(U) - np.repeat(np.cumsum(k) - k, k)
    size = np.repeat(cnt // k, k) + (i_in < np.repeat(cnt % k, k))
    u_end = np.cumsum(size)
    cols[u_end - 1] |= LAST_SLOT
    split = np.repeat(k > 1, k)
    unit_dest = np.repeat(live, k)
    unit_dest[split] = -(np.arange(int(split.sum())) + 1)
    fix, fix_levels, n_parts = _fix_tree(live[k > 1], k[k > 1], fix_fanin)

    # tasks: the elements (units and empty rows) in row order, cut by cost
    is_live = np.zeros(n_out, bool)
    is_live[live] = True
    n_el = np.ones(n_out, np.int64)
    n_el[live] = k
    el_first = np.cumsum(n_el) - n_el  # each row's first element
    is_unit = np.zeros(int(n_el.sum()), bool)
    unit_el = np.repeat(el_first[live], k) + i_in
    is_unit[unit_el] = True
    cost = np.full(len(is_unit), ZERO_COST, np.int64)
    cost[unit_el] = size + UNIT_COST
    task_of = (np.cumsum(cost) - cost) // task_cost
    starts = np.flatnonzero(np.diff(task_of, prepend=-1)) if len(cost) else np.zeros(0, np.int64)
    units_before = np.cumsum(is_unit) - is_unit
    t_unit = units_before[starts]
    t_slot = np.append(0, u_end)[t_unit]
    # runs of empty rows, cut where a task starts
    empty_el = np.flatnonzero(~is_unit)
    empty_rows = np.flatnonzero(~is_live)
    et = np.searchsorted(starts, empty_el, side="right") - 1
    brk = np.ones(len(empty_el), bool)
    brk[1:] = (np.diff(empty_rows) != 1) | (np.diff(et) != 0)
    run_first = np.flatnonzero(brk)
    zero_runs = np.stack([empty_rows[run_first],
                          np.diff(np.append(run_first, len(empty_el)))], axis=1)
    t_zero = np.searchsorted(et[run_first], np.arange(len(starts)), side="left")
    tasks = np.stack([np.append(t_slot, S), np.append(t_unit, U),
                      np.append(t_zero, len(run_first))], axis=1)
    return dict(
        cols=cols.astype(np.uint32).view(np.int32),
        unit_dest=unit_dest.astype(np.int32),
        tasks=tasks.astype(np.int32).reshape(-1, 3),
        zero_runs=zero_runs.astype(np.int32).reshape(-1, 2),
        fix=fix,
        fix_levels=fix_levels,
        n_parts=n_parts,
    )


@dataclasses.dataclass(frozen=True, eq=False)
class RowSchedule:
    """The edge-row kernel's work over one plan (torch tensors on one
    device): the plan's live edges in output-row order, each row's in edge
    order (`row_schedule`'s arrays, with edge ids as the payload).

    cols:      [S] int32 — the edge of each entry (its index in the plan's
      dst-sorted edge list), bit 31 set on the last entry of its unit.
    slot:      [S] int32 or None — the entry's slot (t * e_tile + j) in a
      slot plan, where slot-order values and slot weights are read; None
      for a BAT plan.
    unit_dest, tasks, zero_runs, fix, fix_levels, n_parts: as in
      `row_schedule`.
    n_out:     output rows (the plan's n_blocks * s_tile), each written
      once.
    key:       the plan's tensors it was built from; a plan whose tensors
      are others (a chunk cut out of a plan) does not match it.
    seconds:   its host build time.
    """

    cols: torch.Tensor
    slot: Optional[torch.Tensor]
    unit_dest: torch.Tensor
    tasks: torch.Tensor
    zero_runs: torch.Tensor
    fix: torch.Tensor
    n_parts: int
    fix_levels: tuple
    n_out: int
    key: tuple = ()
    seconds: float = 0.0

    @property
    def nbytes(self) -> int:
        ts = (self.cols, self.slot, self.unit_dest, self.tasks, self.zero_runs, self.fix)
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    def matches(self, key: tuple) -> bool:
        return len(key) == len(self.key) and all(a is b for a, b in zip(key, self.key))

    def to(self, device, key: tuple = ()) -> "RowSchedule":
        def mv(t):
            return None if t is None else t.to(device)

        return dataclasses.replace(
            self, cols=mv(self.cols), slot=mv(self.slot), unit_dest=mv(self.unit_dest),
            tasks=mv(self.tasks), zero_runs=mv(self.zero_runs), fix=mv(self.fix), key=key)


def _in_row_order(row: np.ndarray, *cols):
    """Entries kept in [0, n) and stably sorted by row (a no-op for the
    plans of `build_graph`, whose live slots are already in row order)."""
    if len(row) > 1 and bool(np.any(row[1:] < row[:-1])):
        order = np.argsort(row, kind="stable")
        return (row[order],) + tuple(None if c is None else c[order] for c in cols)
    return (row,) + cols


def slot_plan_entries(dst_slots: np.ndarray, mask: np.ndarray, e0: np.ndarray, n_out: int):
    """(row, edge, slot) of a slot plan's real slots (mask not 0) in row
    order: slot j of tile t holds edge e0[t] + j. Pad slots are left out,
    and so is a slot whose row lies outside [0, n_out)."""
    T, E = dst_slots.shape
    slot = np.flatnonzero(np.asarray(mask).reshape(-1) != 0)
    row = np.asarray(dst_slots).reshape(-1)[slot].astype(np.int64)
    edge = np.asarray(e0, np.int64)[slot // E] + slot % E
    keep = (row >= 0) & (row < n_out)
    return _in_row_order(row[keep], edge[keep], slot[keep])


# edges `bat_plan_entries` reads at a time (~200 MB of int64 temporaries)
_EDGE_STEP = 1 << 22


def bat_plan_entries(out_block: np.ndarray, vblock: np.ndarray, dst_blocks: np.ndarray,
                     s_tile: int, n_out: int):
    """(row, edge) of a BAT plan's live edges in row order: edge b*E + j of
    value block b, with dst d = dst_blocks[b, j] >= 0, is live where the
    plan has the real tile (window d // s_tile, block b) that sums it
    (`bat_tiles_plain`'s rule; a plan repeats no tile). The -1 pads, the
    sentinel block (`vblock` >= n_vblocks: uniformized chunks' pad tiles)
    and edges no tile reaches are left out, and so is a row outside
    [0, n_out). The edges are read `_EDGE_STEP` at a time, so the host
    holds O(nnz) and no [T, E] array (the products remainder's plan has
    24.6 M edges)."""
    nb, E = dst_blocks.shape
    ob = np.asarray(out_block, np.int64)
    vb = np.asarray(vblock, np.int64)
    real = vb < nb
    keys = np.unique(ob[real] * nb + vb[real])
    flat = np.asarray(dst_blocks).reshape(-1)
    rows, edges = [], []
    for e0 in range(0, len(flat), _EDGE_STEP):
        d = flat[e0:e0 + _EDGE_STEP].astype(np.int64)
        e = np.arange(e0, e0 + len(d), dtype=np.int64)
        ok = (d >= 0) & (d < n_out)
        d, e = d[ok], e[ok]
        k = (d // s_tile) * nb + e // E
        pos = np.minimum(np.searchsorted(keys, k), max(len(keys) - 1, 0))
        hit = keys[pos] == k if len(keys) else np.zeros(len(k), bool)
        rows.append(d[hit])
        edges.append(e[hit])
    row = np.concatenate(rows) if rows else np.zeros(0, np.int64)
    edge = np.concatenate(edges) if edges else np.zeros(0, np.int64)
    return _in_row_order(row, edge)


def build_row_schedule(row: np.ndarray, edge: np.ndarray, slot: Optional[np.ndarray],
                       n_out: int, device=None, key: tuple = (), *,
                       slice_slots: int = EDGE_SLICE, fix_fanin: int = EDGE_FANIN,
                       task_cost: int = EDGE_TASK_COST, seconds: float = 0.0) -> RowSchedule:
    """The edge-row kernel's RowSchedule of a plan's entries in row order
    (`slot_plan_entries` / `bat_plan_entries`), on `device`. `seconds`
    adds the time the entries took."""
    t0 = time.perf_counter()
    dev = torch.device("cpu") if device is None else torch.device(device)
    s = row_schedule(row, edge, n_out, slice_slots=slice_slots, fix_fanin=fix_fanin,
                     task_cost=task_cost)

    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return RowSchedule(
        cols=t(s["cols"]), slot=t(None if slot is None else slot.astype(np.int32)),
        unit_dest=t(s["unit_dest"]), tasks=t(s["tasks"]), zero_runs=t(s["zero_runs"]),
        fix=t(s["fix"]), n_parts=s["n_parts"], fix_levels=s["fix_levels"], n_out=int(n_out),
        key=key, seconds=seconds + time.perf_counter() - t0)
