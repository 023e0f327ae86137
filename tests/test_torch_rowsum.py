"""The edge-row kernel's schedule (`graph.row_schedule`, `plan.row_sched`)
and its order of summation, against the JAX package.

- The schedule of slot plans, packed BAT plans and unpacked (wide) BAT
  plans (whole, chunked, uniformized with pad tiles past the next chunk,
  with a hub row cut through 3 or more fix-up levels at small knobs)
  against a brute-force per-row edge list: every live edge once, each
  row's edges in edge order, slices near-equal, every output row written
  once, pads, the sentinel block and out-of-window edges left out.
- A numpy walk in the kernel's order (entries, slices, fix-up levels),
  resolving each entry as `ops/csrc/edge_row_sum.cu` does, against JAX's
  `plan_segment_sum_sr2`, `plan_segment_sum_packed2`,
  `plan_segment_sum_sr_packed`, `bat_segment_sum_packed` and
  `bat_segment_sum` in interpret mode at rtol/atol 2e-4 (the Pallas f32
  kernels multiply through a bf16 hi/lo split; tests/test_ops.py's bound),
  with every fifth weight 0 and values ending mid-block. The walk sums
  each row in edge order within slices of the schedule, then adds the
  slices by the fix-up tree (ROADMAP C.4).
- The slot plans' edge-order src (`Graph.src` for `plan`, `Graph.dst_t`
  for `plan_t`), which `plan_segment_sum_sr_packed` reads in place of
  src_slots: src_slots.flat[slot] == src[edge] on every live entry.
- The fused routes (`slot_dyn`; packed BAT forward and backward), which
  hand the kernel x and src instead of a gathered block, against
  `geot_tpu` `segment_spmm` and its gradients at the tolerances of
  tests/test_torch_aeb.py and tests/test_torch_packed.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geot_tpu.graph import plan as jplan
from geot_tpu.graph.structures import build_graph as jbuild_graph
from geot_tpu.ops import api as japi
from geot_tpu.ops import pallas_segment as jps
from geot_tpu_torch.graph import plan as tplan
from geot_tpu_torch.graph import row_schedule as trs
from geot_tpu_torch.graph.structures import build_graph as tbuild_graph
from geot_tpu_torch.ops import api as tapi

TOL = dict(rtol=2e-4, atol=2e-4)
SMALL = dict(slice_slots=4, fix_fanin=2, task_cost=16)


def _hubby_sorted(rng, n, nnz, hub_edges, hub=7):
    dst = np.concatenate([np.full(hub_edges, hub, np.int32),
                          rng.integers(0, n, nnz).astype(np.int32)])
    src = rng.integers(0, n, len(dst)).astype(np.int32)
    order = np.argsort(dst, kind="stable")
    return src[order], dst[order]


def _np(t):
    return None if t is None else t.cpu().numpy()


def _entry_rows(s):
    """Each scheduled entry's output row, following slices through the
    fix-up tree, and each unit's entry count."""
    cols = _np(s.cols).view(np.uint32).astype(np.int64)
    ends = np.flatnonzero(cols >> 31) + 1
    starts = np.concatenate([[0], ends[:-1]]).astype(np.int64)
    dest = _np(s.unit_dest).astype(np.int64)
    assert len(dest) == len(ends) and (len(cols) == 0 or ends[-1] == len(cols))
    part_dest = {}
    for d, p0, p1 in _np(s.fix).astype(np.int64):
        for p in range(p0, p1):
            part_dest[p] = d

    def row_of(d):
        while d < 0:
            d = part_dest[-d - 1]
        return d

    unit_row = np.array([row_of(d) for d in dest], np.int64)
    return np.repeat(unit_row, ends - starts), ends - starts


def _check_schedule(s, row, edge, n_out, slice_slots=trs.EDGE_SLICE,
                    fix_fanin=trs.EDGE_FANIN, task_cost=trs.EDGE_TASK_COST):
    """A RowSchedule against the brute-force (row, edge) lists: the same
    entries, rows in order and each row's edges in edge order, slices of a
    row consecutive and near-equal, fix-up entries reading only partials
    made before their level, every output row written exactly once."""
    order = np.lexsort((edge, row))
    cols = _np(s.cols).view(np.uint32).astype(np.int64)
    np.testing.assert_array_equal(cols & 0x7FFFFFFF, edge[order])
    got_row, sizes = _entry_rows(s)
    np.testing.assert_array_equal(got_row, row[order])
    assert s.n_out == n_out
    # slices: a row of n entries is ceil(n / slice_slots) units of
    # near-equal size
    first_of_unit = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    urow = got_row[first_of_unit] if len(sizes) else np.zeros(0, np.int64)
    for r in np.unique(urow):
        sz = sizes[urow == r]
        n = int(sz.sum())
        assert len(sz) == -(-n // slice_slots) and sz.max() - sz.min() <= 1
    # the fix-up tree
    fix, lv = _np(s.fix).astype(np.int64), s.fix_levels
    assert lv[0] == 0 and lv[-1] == len(fix)
    assert ((fix[:, 2] - fix[:, 1] >= 1) & (fix[:, 2] - fix[:, 1] <= fix_fanin)).all()
    ready = int((_np(s.unit_dest) < 0).sum())
    for lo, hi in zip(lv[:-1], lv[1:]):
        assert (fix[lo:hi, 2] <= ready).all()
        ready += int((fix[lo:hi, 0] < 0).sum())
    assert ready == s.n_parts
    # tasks cover every entry, unit and zero run once, in order
    tasks = _np(s.tasks).astype(np.int64)
    assert (np.diff(tasks, axis=0) >= 0).all() and tasks[0].tolist() == [0, 0, 0]
    assert tasks[-1].tolist() == [len(cols), len(sizes), len(_np(s.zero_runs))]
    z = _np(s.zero_runs).astype(np.int64)
    zr = np.concatenate([[0], np.cumsum(z[:, 1])])
    for t in range(len(tasks) - 1):  # each under task_cost plus one element
        cost = (tasks[t + 1, 0] - tasks[t, 0] + (tasks[t + 1, 1] - tasks[t, 1]) * trs.UNIT_COST
                + (zr[tasks[t + 1, 2]] - zr[tasks[t, 2]]) * trs.ZERO_COST)
        assert cost <= task_cost + slice_slots + trs.UNIT_COST
    # every output row written once: a whole row's unit, a fix-up entry, or
    # a run of zeros
    written = np.zeros(n_out, np.int64)
    d = _np(s.unit_dest).astype(np.int64)
    np.add.at(written, d[d >= 0], 1)
    np.add.at(written, fix[fix[:, 0] >= 0, 0], 1)
    for r0, c in _np(s.zero_runs):
        written[r0:r0 + c] += 1
    assert (written == 1).all()


def _slot_brute(plan):
    """(row, edge) of a slot plan's real slots, by a loop over its tiles."""
    dst, mask, e0 = _np(plan.dst_slots), _np(plan.mask), _np(plan.e0)
    rows, edges = [], []
    for t in range(plan.num_tiles):
        for j in range(plan.e_tile):
            if mask[t, j] != 0:
                rows.append(dst[t, j])
                edges.append(int(e0[t]) + j)
    return np.array(rows, np.int64), np.array(edges, np.int64)


def _bat_brute(dst_sorted):
    """(row, edge) of a BAT plan: each edge once, into its dst (the plan
    covers every edge of the dst-sorted list exactly once)."""
    return dst_sorted.astype(np.int64), np.arange(len(dst_sorted), dtype=np.int64)


@pytest.mark.parametrize("knobs", [{}, SMALL])
@pytest.mark.parametrize("chunked", [False, True])
def test_slot_row_schedule_vs_brute_force(knobs, chunked):
    """A slot plan's schedule: real slots only (pads, also the pad tiles of
    uniformized chunks, left out), rows past num_segments empty, a hub row
    cut into slices (3 or more fix-up levels at slices of 4 and fan-in 2),
    and a chunked plan scheduled whole."""
    rng = np.random.default_rng(3 + chunked)
    src, dst = _hubby_sorted(rng, 300, 1500, 600, hub=5)
    plan = tplan.build_segment_plan(dst, src, 400, e_tile=64, s_tile=32, pack_align=16,
                                    max_chunk_slots=64 * 4 if chunked else 4 << 20, device="cpu")
    assert bool(plan.chunks) == chunked
    if knobs:
        plan = tplan.with_row_schedule(plan, **knobs)
        assert len(plan.row_sched.fix_levels) - 1 >= 3
    s = plan.row_sched
    assert s is not None and s.matches(tplan._sched_key(plan))
    row, edge = _slot_brute(plan)
    assert len(edge) == len(dst)
    _check_schedule(s, row, edge, plan.n_blocks * plan.s_tile, **knobs)
    # entries name their slots: slot j of tile t holds edge e0[t] + j
    slot = _np(s.slot)
    cols = _np(s.cols).view(np.uint32).astype(np.int64) & 0x7FFFFFFF
    np.testing.assert_array_equal(_np(plan.e0)[slot // 64] + slot % 64, cols)
    assert (_np(plan.mask).reshape(-1)[slot] == 1).all()
    # rows past num_segments (the windows' tail) are zero runs
    z = _np(s.zero_runs)
    empty = np.concatenate([np.arange(r, r + c) for r, c in z])
    assert set(range(400, plan.n_blocks * 32)) <= set(empty.tolist())


@pytest.mark.parametrize("knobs", [{}, SMALL])
@pytest.mark.parametrize("pack", [2, 16])
@pytest.mark.parametrize("chunked", [False, True])
def test_bat_row_schedule_vs_brute_force(knobs, pack, chunked):
    """A packed BAT plan's schedule, dst ids read from its k-major copy:
    each edge once into its row, the -1 pads of the last value block and
    the sentinel block (uniformized chunks' pad tiles) left out, blocks
    spanning windows split between their rows, a chunked plan whole."""
    rng = np.random.default_rng(pack + chunked)
    _, dst = _hubby_sorted(rng, 200, 1000, 700, hub=3)
    bp = tplan.build_bat_plan(dst, 260, e_tile=64, s_tile=32, km_pack=pack,
                              max_chunk_tiles=6 if chunked else 8192, device="cpu")
    assert bool(bp.chunks) == chunked and bp.row_sched is not None
    if knobs:
        bp = tplan.with_row_schedule(bp, **knobs)
        assert len(bp.row_sched.fix_levels) - 1 >= 3
    assert bp.row_sched.slot is None
    row, edge = _bat_brute(dst)
    _check_schedule(bp.row_sched, row, edge, bp.n_blocks * bp.s_tile, **knobs)


def test_row_schedule_made_for_a_chunk_cut_out_of_a_plan():
    """A plan without a schedule made for it (a chunk cut out of a plan:
    its rows rebased) gets one on first use, from its own tensors; the
    whole plan's stays with it, and `BatPlan.to` carries it along."""
    rng = np.random.default_rng(1)
    src, dst = _hubby_sorted(rng, 300, 1500, 600, hub=5)
    plan = tplan.build_segment_plan(dst, src, 300, e_tile=64, s_tile=32,
                                    max_chunk_slots=64 * 4, device="cpu")
    c = plan.chunks[1]
    cp = tapi._chunk_plan(plan, c)
    assert not cp.row_sched.matches(tplan._sched_key(cp))
    s = tplan.row_schedule_of(cp)
    assert s.matches(tplan._sched_key(cp)) and tplan.row_schedule_of(cp) is s
    assert tplan.row_schedule_of(plan) is plan.row_sched
    row, edge = _slot_brute(cp)
    _check_schedule(s, row, edge, cp.n_blocks * cp.s_tile)
    bp = tplan.build_bat_plan(dst, 300, e_tile=64, s_tile=32, km_pack=4, device="cpu")
    moved = bp.to("cpu")
    assert moved.row_sched.matches(tplan._sched_key(moved))
    assert tplan.row_schedule_of(moved) is moved.row_sched
    # an unpacked plan carries one too, keyed by dst3; a plan holding other
    # tiles (here the first half) gets its own on first use
    wide = tplan.build_bat_plan(dst, 300, e_tile=64, s_tile=32, device="cpu")
    assert wide.row_sched is not None and tplan.row_schedule_of(wide) is wide.row_sched
    half = dataclasses.replace(wide, out_block=wide.out_block[: wide.num_tiles // 2],
                               vblock=wide.vblock[: wide.num_tiles // 2])
    s = tplan.row_schedule_of(half)
    assert s is not wide.row_sched and s.matches(tplan._sched_key(half))
    ob, vb = half.out_block.numpy(), half.vblock.numpy()
    keep = np.isin(dst.astype(np.int64) // 32 * 10**6 + np.arange(len(dst)) // 64,
                   ob.astype(np.int64) * 10**6 + vb)
    row, edge = _bat_brute(dst)
    _check_schedule(s, row[keep], edge[keep], half.n_blocks * 32)


def _walk(s, vals, *, src=None, e_base=0, by_slot=False, w_slots=None, w_edge=None,
          skip_zero=False):
    """The edge-row kernel's sums in its order, in float32: each entry
    resolved as `resolve` in edge_row_sum.cu does (v and w), each unit's
    entries added in order from 0, the fix-up levels in order, each
    entry's partials in order. Returns [n_out, F]."""
    cols = _np(s.cols).view(np.uint32).astype(np.int64)
    e = cols & 0x7FFFFFFF
    slot = _np(s.slot)
    w = np.ones(len(e), np.float32)
    if w_slots is not None:
        w = w_slots.reshape(-1)[slot].astype(np.float32)
    if w_edge is not None:
        we = np.where(e < len(w_edge), w_edge[np.minimum(e, len(w_edge) - 1)], 0.0)
        w = np.where(w != 0, w * we.astype(np.float32), w).astype(np.float32)
    if src is not None:
        r = np.where(e < len(src), src[np.minimum(e, len(src) - 1)], -1).astype(np.int64)
    elif by_slot:
        r = slot.astype(np.int64)
    else:
        r = e - e_base
    live = (r >= 0) & (r < vals.shape[0]) & ~(skip_zero & (w == 0))
    w = np.where(live, w, 0).astype(np.float32)
    v = np.zeros((len(e), vals.shape[1]), np.float32)
    v[live] = vals[r[live]]
    terms = (w[:, None] * v).astype(np.float32)
    part = np.zeros((s.n_parts, vals.shape[1]), np.float32)
    out = np.full((s.n_out, vals.shape[1]), np.nan, np.float32)

    def ordered_sum(vecs, first, count):
        acc = np.zeros((len(first), vecs.shape[1]), np.float32)
        for i in range(int(count.max(initial=0))):
            m = count > i
            acc[m] = acc[m] + vecs[first[m] + i]
        return acc

    def put(dest, acc):
        fin = dest >= 0
        out[dest[fin]] = acc[fin]
        part[-dest[~fin] - 1] = acc[~fin]

    ends = np.flatnonzero(cols >> 31) + 1
    starts = np.concatenate([[0], ends[:-1]]).astype(np.int64)
    put(_np(s.unit_dest).astype(np.int64), ordered_sum(terms, starts, ends - starts))
    fix = _np(s.fix).astype(np.int64)
    for lo, hi in zip(s.fix_levels[:-1], s.fix_levels[1:]):
        f = fix[lo:hi]
        put(f[:, 0], ordered_sum(part, f[:, 1], f[:, 2] - f[:, 1]))
    for r0, c in _np(s.zero_runs):
        out[r0:r0 + c] = 0
    assert not np.isnan(out).any()
    return out


def _aeb_plans(rng, pack_align, e_tile=128, n=400):
    src, dst = _hubby_sorted(rng, n, 1500, 500)
    kw = dict(e_tile=e_tile, s_tile=128, pack_align=pack_align, num_src_nodes=n)
    return (jplan.build_segment_plan(dst, src, n + 100, **kw),
            tplan.build_segment_plan(dst, src, n + 100, **kw, device="cpu"), src, dst)


@pytest.mark.parametrize("knobs", [{}, SMALL])
@pytest.mark.parametrize("layout,kind", [("slot", "static"), ("slot", "dynamic"),
                                         ("edge", "static"), ("edge", "dynamic"),
                                         ("edge", "both")])
def test_walk_sr2_vs_pallas(knobs, layout, kind):
    """The kernel's order over a slot plan's schedule against JAX's sr2 in
    interpret mode (F 128): values in slot or edge order (edge order:
    exactly nnz rows, the last tile ending mid-block), static and/or
    per-call weights with every fifth one 0 (skipped: C.9)."""
    rng = np.random.default_rng(len(layout) + len(kind) + len(knobs))
    jp, tp, src, dst = _aeb_plans(rng, 16, e_tile=64)
    if knobs:
        tp = tplan.with_row_schedule(tp, **knobs)
    T, E, nnz = tp.num_tiles, tp.e_tile, len(dst)
    assert nnz % E
    ws = we = None
    if kind in ("static", "both"):
        ws = (_np(tp.mask) * rng.standard_normal((T, E))).astype(np.float32)
        ws.reshape(-1)[::5] = 0.0
    if kind in ("dynamic", "both"):
        we = rng.standard_normal(nnz).astype(np.float32)
        we[::5] = 0.0
    v = rng.standard_normal((T * E if layout == "slot" else nnz, 128)).astype(np.float32)
    j = jps.plan_segment_sum_sr2(jp, jnp.asarray(v), vals_layout=layout,
                                 w_slots=None if ws is None else jnp.asarray(ws),
                                 w_edge=None if we is None else jnp.asarray(we),
                                 interpret=True)
    got = _walk(tp.row_sched, v, by_slot=layout == "slot", w_slots=ws, w_edge=we,
                skip_zero=True)
    np.testing.assert_allclose(got, np.asarray(j), **TOL)


@pytest.mark.parametrize("knobs", [{}, SMALL])
@pytest.mark.parametrize("F", [8, 16, 64])
@pytest.mark.parametrize("form", ["values", "gathered"])
def test_walk_packed2_vs_pallas(knobs, F, form):
    """The kernel's order against JAX's packed2 in interpret mode on a
    pack-aligned plan, per-call weights with every fifth one 0; the
    gathered form (edge e reads x[src[e]]) against JAX's packed2 of the
    gathered edge-order block."""
    rng = np.random.default_rng(F + len(form) + len(knobs))
    jp, tp, src, dst = _aeb_plans(rng, 16)
    if knobs:
        tp = tplan.with_row_schedule(tp, **knobs)
    nnz = len(dst)
    we = rng.standard_normal(nnz).astype(np.float32)
    we[::5] = 0.0
    x = rng.standard_normal((400, F)).astype(np.float32)
    v = x[src]
    j = jps.plan_segment_sum_packed2(jp, jnp.asarray(v), w_edge=jnp.asarray(we), interpret=True)
    if form == "gathered":
        got = _walk(tp.row_sched, x, src=src, w_edge=we, skip_zero=True)
    else:
        got = _walk(tp.row_sched, v, w_edge=we, skip_zero=True)
    np.testing.assert_allclose(got, np.asarray(j), **TOL)


@pytest.mark.parametrize("knobs", [{}, SMALL])
@pytest.mark.parametrize("pack", [2, 4, 16])
@pytest.mark.parametrize("form", ["values", "gathered"])
def test_walk_bat_packed_vs_pallas(knobs, pack, form):
    """The kernel's order over a packed BAT plan against JAX's
    bat_segment_sum_packed in interpret mode: exactly nnz value rows (the
    last block partial), weights with every fifth one 0 (added as 0 * v),
    and the gathered form."""
    rng = np.random.default_rng(pack + len(form) + len(knobs))
    src, dst = _hubby_sorted(rng, 150, 700, 200)
    nnz = len(dst)
    arrays, meta = jplan.build_bat_plan_host(dst, 150, e_tile=64, s_tile=32, km_pack=pack)
    jbp = jplan.bat_plan_from_host(arrays, meta)
    tbp = tplan.bat_plan_from_host(arrays, meta)
    if knobs:
        tbp = tplan.with_row_schedule(tbp, **knobs)
    assert nnz % 64
    F = 128 // pack
    w = rng.standard_normal(nnz).astype(np.float32)
    w[::5] = 0.0
    x = rng.standard_normal((150, F)).astype(np.float32)
    v = x[src]
    j = jps.bat_segment_sum_packed(jbp, jnp.asarray(v), jnp.asarray(w), interpret=True)
    if form == "gathered":
        got = _walk(tbp.row_sched, x, src=src, w_edge=w)
    else:
        got = _walk(tbp.row_sched, v, w_edge=w)
    np.testing.assert_allclose(got, np.asarray(j), **TOL)


def test_walk_chunked_plans_whole():
    """A uniformized chunked plan (slot and packed BAT) walked whole in one
    pass against JAX's kernels over the unchunked plan of the same edges:
    the chunks of the TPU's limits are not the card's."""
    rng = np.random.default_rng(9)
    src, dst = _hubby_sorted(rng, 300, 1500, 700, hub=4)
    nnz = len(dst)
    we = rng.standard_normal(nnz).astype(np.float32)
    we[::5] = 0.0
    x = rng.standard_normal((300, 16)).astype(np.float32)
    kw = dict(e_tile=128, s_tile=64, pack_align=16, num_src_nodes=300)
    jp = jplan.build_segment_plan(dst, src, 300, **kw)
    tc = tplan.build_segment_plan(dst, src, 300, max_chunk_slots=128 * 3, **kw, device="cpu")
    assert len(tc.chunks) > 2 and any(b[2] < a[3] for a, b in zip(tc.chunks[:-1],
                                                                   tc.chunks[1:]))
    j = jps.plan_segment_sum_packed2(jp, jnp.asarray(x[src]), w_edge=jnp.asarray(we),
                                     interpret=True)
    got = _walk(tc.row_sched, x, src=src, w_edge=we, skip_zero=True)
    n_rows = min(got.shape[0], np.asarray(j).shape[0])
    np.testing.assert_allclose(got[:n_rows], np.asarray(j)[:n_rows], **TOL)
    arrays, meta = jplan.build_bat_plan_host(dst, 300, e_tile=64, s_tile=32, km_pack=8)
    ca, cm = jplan.build_bat_plan_host(dst, 300, e_tile=64, s_tile=32, km_pack=8,
                                       max_chunk_tiles=5)
    assert cm["chunks"]
    jb = jps.bat_segment_sum_packed(jplan.bat_plan_from_host(arrays, meta),
                                    jnp.asarray(x[src]), jnp.asarray(we), interpret=True)
    got = _walk(tplan.bat_plan_from_host(ca, cm).row_sched, x, src=src, w_edge=we)
    np.testing.assert_allclose(got[:300], np.asarray(jb)[:300], **TOL)


def _record(monkeypatch, name):
    """Wrap ops.api's `name` to record whether each call passed src."""
    calls = []
    fn = getattr(tapi, name)

    def spy(*a, **kw):
        calls.append(kw.get("src") is not None)
        return fn(*a, **kw)

    monkeypatch.setattr(tapi, name, spy)
    return calls


@pytest.mark.parametrize("n_feat,feature_hint", [(16, 64), (7, 128), (128, 128)])
@pytest.mark.parametrize("chunked", [False, True])
def test_slot_dyn_fused_route_vs_jax(monkeypatch, n_feat, feature_hint, chunked):
    """slot_dyn hands the AEB function x and src (no [nnz, n] gather), one
    call per plan, chunked or not: segment_spmm with per-call weights,
    forward, dx and dw against geot_tpu's segment_spmm and jax.grad, at
    test_torch_aeb.py's 2e-4."""
    rng = np.random.default_rng(n_feat + feature_hint + chunked)
    n = 200
    src, dst = _hubby_sorted(rng, n, 1200, 500, hub=5)
    kw = dict(e_tile=64, s_tile=64, bat_e_tile=64, bat_s_tile=32, feature_hint=feature_hint,
              layouts=("slot",))
    jg = jbuild_graph(src, dst, n, **kw)
    tg = tbuild_graph(src, dst, n, prefer_dyn="sr", device="cpu",
                      max_chunk_slots=64 * 4 if chunked else 4 << 20, **kw)
    assert bool(tg.plan.chunks) == chunked
    assert tapi.dispatch_path(tg, dynamic_w=True) == "slot_dyn"
    name = ("plan_segment_sum_packed2" if tapi._aeb_packed_ok(tg.plan, n_feat)
            else "plan_segment_sum_sr2")
    calls = _record(monkeypatch, name)
    x = rng.standard_normal((n, n_feat)).astype(np.float32)
    w = rng.standard_normal(len(dst)).astype(np.float32)
    cot = rng.standard_normal((n, n_feat)).astype(np.float32)

    def jloss(xx, ww):
        out = japi.segment_spmm(jg, xx, ww, backend="pallas")
        return jnp.vdot(out, jnp.asarray(cot)), out

    (_, jout), (jdx, jdw) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = tapi.segment_spmm(tg, xt, edge_weight=wt)
    assert calls == [True]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    torch.vdot(out.reshape(-1), torch.from_numpy(cot).reshape(-1)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw), **TOL)


@pytest.mark.parametrize("n_feat", [7, 40])
@pytest.mark.parametrize("mode", ["unweighted", "dynamic"])
@pytest.mark.parametrize("chunked", [False, True])
def test_packed_bat_fused_route_vs_jax(monkeypatch, n_feat, mode, chunked):
    """The packed BAT routes hand the kernel x and src, forward over `bat`
    and backward over `bat_t`, one call per plan (chunked or not): the
    bat and bat_dyn routes with dx (and dw) against geot_tpu's Pallas path
    at test_torch_packed.py's 2e-4."""
    rng = np.random.default_rng(n_feat + len(mode) + chunked)
    n = 160
    src, dst = _hubby_sorted(rng, n, 400, 600, hub=3)
    kw = dict(e_tile=64, s_tile=64, bat_e_tile=64, bat_s_tile=64, feature_hint=n_feat)
    budget = 4 * 64 * n_feat * 4 if chunked else 1 << 30
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOT_MAX_CHUNK_BYTES", str(budget))
        jg = jbuild_graph(src, dst, n, layouts=("bat",), **kw)
    tg = tbuild_graph(src, dst, n, max_chunk_bytes=budget, layouts=("bat",), device="cpu",
                      **kw)
    assert bool(tg.bat.chunks) == chunked and tg.bat.km_pack > 1
    calls = _record(monkeypatch, "bat_segment_sum_packed")
    dyn = mode == "dynamic"
    x = rng.standard_normal((n, n_feat)).astype(np.float32)
    w = rng.standard_normal(len(dst)).astype(np.float32)
    cot = rng.standard_normal((n, n_feat)).astype(np.float32)

    def jop(xx, ww):
        return japi.segment_spmm(jg, xx, ww if dyn else None, backend="pallas")

    jout = jop(jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = jax.grad(lambda xx, ww: jnp.vdot(jop(xx, ww), jnp.asarray(cot)),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_(dyn)
    out = tapi.segment_spmm(tg, tx, edge_weight=tw if dyn else None)
    torch.vdot(out.reshape(-1), torch.from_numpy(cot).reshape(-1)).backward()
    assert calls == [True, True]  # forward over bat, dx over bat_t
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **TOL)
    if dyn:
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **TOL)


def _uniformized_cap(dst, n, e_tile, s_tile):
    """A chunk cap whose uniformized chunks put pad tiles past the next
    chunk's first window (out_block not monotone over the plan)."""
    for cap in (12, 10, 8, 6, 5, 4, 3):
        ob = tplan.build_bat_plan_host(dst, n, e_tile=e_tile, s_tile=s_tile,
                                       max_chunk_tiles=cap)[0]["out_block"]
        if np.any(ob[1:] < ob[:-1]):
            return cap
    raise AssertionError("no cap gives pad tiles past the next chunk")


@pytest.mark.parametrize("knobs", [{}, SMALL])
@pytest.mark.parametrize("kind", ["whole", "chunked", "uniformized"])
def test_wide_bat_row_schedule_vs_brute_force(knobs, kind):
    """An unpacked BAT plan's schedule, built from dst3: whole, forced into
    ragged chunks that split the hub window (`with_chunks`: the schedule
    comes along), and uniformized with pad tiles that point at the
    sentinel block and past the next chunk's first window (left out, no
    order assumed), each edge once into its row."""
    rng = np.random.default_rng(len(kind) + len(knobs))
    _, dst = _hubby_sorted(rng, 200, 1000, 700, hub=3)
    cap = _uniformized_cap(dst, 260, 64, 32) if kind == "uniformized" else 8192
    bp = tplan.build_bat_plan(dst, 260, e_tile=64, s_tile=32, max_chunk_tiles=cap, device="cpu")
    assert bp.dst_km is None and bp.row_sched is not None
    if kind == "chunked":
        ch = tplan.compute_chunks(bp.out_block.numpy(), 4)
        assert any(b[2] < a[3] for a, b in zip(ch[:-1], ch[1:]))
        bp = tplan.with_chunks(bp, ch)
        assert tplan.row_schedule_of(bp) is bp.row_sched
    if kind == "uniformized":
        ob = bp.out_block.numpy()
        assert np.any(ob[1:] < ob[:-1]) and (bp.vblock.numpy() == bp.n_vblocks).any()
        # the same entries as the unchunked plan's, so the same sums bit for bit
        whole = tplan.build_bat_plan(dst, 260, e_tile=64, s_tile=32, device="cpu").row_sched
        for k in ("cols", "unit_dest", "tasks", "zero_runs", "fix"):
            assert torch.equal(getattr(bp.row_sched, k), getattr(whole, k)), k
    if knobs:
        bp = tplan.with_row_schedule(bp, **knobs)
        assert len(bp.row_sched.fix_levels) - 1 >= 3
    assert bp.row_sched.slot is None
    row, edge = _bat_brute(dst)
    _check_schedule(bp.row_sched, row, edge, bp.n_blocks * bp.s_tile, **knobs)


@pytest.mark.parametrize("knobs", [{}, SMALL])
@pytest.mark.parametrize("f_pad,pack", [(128, 0), (256, 0), (128, 2)])
@pytest.mark.parametrize("form", ["values", "gathered"])
def test_walk_bat_wide_vs_pallas(knobs, f_pad, pack, form):
    """The kernel's order over a BAT plan's schedule against JAX's wide
    bat_segment_sum in interpret mode (F_pad 128 and 256): unpacked plans
    (schedule from dst3) and a packed one at the wide width (GIN's 128-wide
    layer 1 over its km_pack 2 plan, schedule from dst_km), exactly nnz
    value rows (the last block partial), weights with every fifth one 0
    (added as 0 * v), and the gathered form (x[src[e]])."""
    rng = np.random.default_rng(f_pad + pack + len(form) + len(knobs))
    src, dst = _hubby_sorted(rng, 150, 700, 200)
    nnz = len(dst)
    arrays, meta = jplan.build_bat_plan_host(dst, 150, e_tile=64, s_tile=32, km_pack=pack)
    jbp = jplan.bat_plan_from_host(arrays, meta)
    tbp = tplan.bat_plan_from_host(arrays, meta)
    assert (tbp.dst_km is not None) == bool(pack)
    if knobs:
        tbp = tplan.with_row_schedule(tbp, **knobs)
    assert nnz % 64
    w = rng.standard_normal(nnz).astype(np.float32)
    w[::5] = 0.0
    x = rng.standard_normal((150, f_pad)).astype(np.float32)
    v = x[src]
    j = jps.bat_segment_sum(jbp, jnp.asarray(v), jnp.asarray(w), f_tile=min(f_pad, 256),
                            interpret=True)
    if form == "gathered":
        got = _walk(tbp.row_sched, x, src=src, w_edge=w)
    else:
        got = _walk(tbp.row_sched, v, w_edge=w)
    np.testing.assert_allclose(got, np.asarray(j), **TOL)
    # the kernel's f32 regrouping (edge order within slices, then the
    # fix-up tree; ROADMAP C.4) against the float64 sum: rows up to ~45 in
    # magnitude, a 200-edge hub row
    exp = np.zeros(got.shape)
    np.add.at(exp, dst, w[:, None].astype(np.float64) * v)
    np.testing.assert_allclose(got, exp, rtol=0, atol=2e-5)


@pytest.mark.parametrize("knobs", [{}, SMALL])
@pytest.mark.parametrize("F", [8, 16, 32, 64])
@pytest.mark.parametrize("form", ["values", "gathered"])
def test_walk_sr_packed_vs_pallas(knobs, F, form):
    """The kernel's order over a slot plan's schedule against JAX's
    plan_segment_sum_sr_packed in interpret mode: slot weights with every
    fifth one 0 (skipped: C.9), values in slot order (x[src_slots]) or
    gathered (x[src[e]], src the plan's edge-order src)."""
    rng = np.random.default_rng(F + len(form) + len(knobs))
    jp, tp, src, dst = _aeb_plans(rng, 16)
    if knobs:
        tp = tplan.with_row_schedule(tp, **knobs)
    T, E = tp.num_tiles, tp.e_tile
    ws = (_np(tp.mask) * rng.standard_normal((T, E))).astype(np.float32)
    ws.reshape(-1)[::5] = 0.0
    x = rng.standard_normal((400, F)).astype(np.float32)
    v = x[_np(tp.src_slots).reshape(-1)]
    j = jps.plan_segment_sum_sr_packed(jp, jnp.asarray(v), jnp.asarray(ws), interpret=True)
    if form == "gathered":
        got = _walk(tp.row_sched, x, src=src, w_slots=ws, skip_zero=True)
    else:
        got = _walk(tp.row_sched, v, by_slot=True, w_slots=ws, skip_zero=True)
    np.testing.assert_allclose(got, np.asarray(j), **TOL)


@pytest.mark.parametrize("chunked", [False, True])
def test_slot_plans_src_by_edge(chunked):
    """`plan_segment_sum_sr_packed`'s gathered form reads x[src[e]] with src
    the plan's edge-order src: `Graph.src` for `plan` (built over (dst,
    src)) and `Graph.dst_t` for `plan_t` (built over (src_t, dst[perm_t])).
    On every live entry of both schedules, src_slots.flat[slot] equals
    src[edge]."""
    rng = np.random.default_rng(11 + chunked)
    src, dst = _hubby_sorted(rng, 300, 2000, 700, hub=9)
    g = tbuild_graph(src, dst, 300, e_tile=64, s_tile=64, layouts=("slot",), device="cpu",
                     max_chunk_slots=64 * 4 if chunked else 4 << 20)
    assert bool(g.plan.chunks) == chunked
    for plan, src_e in ((g.plan, g.src), (g.plan_t, g.dst_t)):
        s = plan.row_sched
        edge = _np(s.cols).view(np.uint32).astype(np.int64) & 0x7FFFFFFF
        np.testing.assert_array_equal(_np(plan.src_slots).reshape(-1)[_np(s.slot)],
                                      _np(src_e)[edge])
        assert len(edge) == len(dst)
