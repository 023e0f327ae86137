"""The port's hybrid stream+gather path against the JAX package's.

Mirrors `tests/test_stream.py`: the same numpy edges go through both
packages' stream planners (arrays must be equal), the port's plain stream
kernels are held against JAX's `stream_segment_acc` / `stream_segment_sum`
in interpret mode, and the hybrid `segment_spmm`, its x gradient and
`gather_scatter` against JAX's hybrid path. JAX's interpret-mode stream
kernel selects rows with a one-hot product under a hi/lo bf16 split
(~2^-16 relative): tolerance rtol/atol 2e-4, the SpMM paths' bound in
ROADMAP. bfloat16 inputs: both packages sum in float32 and round the
output to bfloat16 (the reference also rounds the weights), so the
tolerance is test_stream.py's bf16 budget, rtol 0.05, atol 0.2.

Every graph here lies off the tuning-table bucket `spmm_hyb:7:13:1`
(feature 128, 8-16 k edges, average degree 2-4), where the JAX package
vetoes streaming and the port, which reads no table, would not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geot_tpu.graph import stream_plan as jsp
from geot_tpu.graph.datasets import synthetic_clustered_graph as jclustered
from geot_tpu.graph.structures import build_graph as jbuild_graph
from geot_tpu.ops import api as japi
from geot_tpu.ops.pallas_segment import stream_segment_acc as jstream_acc
from geot_tpu.ops.pallas_segment import stream_segment_sum as jstream_sum
from geot_tpu_torch.graph import stream_plan as tsp
from geot_tpu_torch.graph import structures as tstructures
from geot_tpu_torch.graph.datasets import synthetic_clustered_graph as tclustered
from geot_tpu_torch.graph.structures import build_graph as tbuild_graph
from geot_tpu_torch.ops import api as tapi
from geot_tpu_torch.ops.stream_kernels import (
    stream_segment_acc,
    stream_segment_acc_plain,
    stream_segment_sum,
    stream_segment_sum_plain,
)

TOL = dict(rtol=2e-4, atol=2e-4)
TOL_BF16 = dict(rtol=0.05, atol=0.2)
TILES = dict(e_tile=512, s_tile=256, bat_e_tile=1024, bat_s_tile=256)
LOW_FRAC = tsp.StreamKnobs(min_stream_frac=0.05)


def _clustered_edges(n, nnz_dense, nnz_uniform, s_tile=256, x_rows=256, seed=0):
    """Dense (window, block) cells of 1500 edges plus uniform noise, dst-
    sorted (test_stream.py's generator)."""
    rng = np.random.default_rng(seed)
    n_w = max(n // s_tile, 1)
    n_b = max(n // x_rows, 1)
    epc = 1500
    n_cells = max(nnz_dense // epc, 1)
    cw = rng.integers(0, n_w, n_cells)
    cb = rng.integers(0, n_b, n_cells)
    dst = (cw[:, None] * s_tile + rng.integers(0, s_tile, (n_cells, epc))).reshape(-1)
    src = (cb[:, None] * x_rows + rng.integers(0, x_rows, (n_cells, epc))).reshape(-1)
    dst = np.concatenate([dst, rng.integers(0, n, nnz_uniform)])
    src = np.concatenate([src, rng.integers(0, n, nnz_uniform)])
    dst = np.minimum(dst, n - 1)
    src = np.minimum(src, n - 1)
    order = np.argsort(dst, kind="stable")
    return src[order].astype(np.int32), dst[order].astype(np.int32)


def _ref(src, dst, x, n, w=None):
    v = x[src].astype(np.float64)
    if w is not None:
        v = v * w[:, None]
    out = np.zeros((n, x.shape[1]))
    np.add.at(out, dst, v)
    return out


def _assert_split_equal(jres, tres):
    (fj, rj, sj), (ft, rt, st) = jres, tres
    np.testing.assert_array_equal(rj, rt)
    assert sj == st
    assert (fj is None) == (ft is None)
    for (aj, mj), (at, mt) in zip(fj or (), ft or ()):
        assert mj == mt
        assert set(aj) == set(at)
        for k in aj:
            assert aj[k].dtype == at[k].dtype, k
            np.testing.assert_array_equal(aj[k], at[k], err_msg=k)


def _mixed_edges():
    """test_stream.py's mixed-family graph: one 4000-edge cell in the last
    (window, block) beside 1500-edge cells in earlier windows."""
    n = 4096
    rng = np.random.default_rng(9)
    dst_h = n - 256 + rng.integers(0, 256, 4000)
    src_h = n - 256 + rng.integers(0, 256, 4000)
    src_m, dst_m = _clustered_edges(n - 512, 18_000, 0, seed=10)
    dst = np.concatenate([dst_h, dst_m]).astype(np.int64)
    src = np.concatenate([src_h, src_m]).astype(np.int64)
    order = np.argsort(dst, kind="stable")
    return n, src[order], dst[order]


@pytest.mark.parametrize("weighted", [False, True])
def test_stream_split_matches_reference(weighted):
    n = 1500
    src, dst = _clustered_edges(n, 30_000, 3_000)
    rng = np.random.default_rng(1)
    w = rng.standard_normal(len(src)).astype(np.float32) if weighted else None
    tres = tsp.build_stream_split_host(dst, src, n, n, edge_weight=w, knobs=LOW_FRAC,
                                        uniformize=True)
    jres = jsp.build_stream_split_host(dst, src, n, n, edge_weight=w, min_stream_frac=0.05)
    _assert_split_equal(jres, tres)
    families, rest_mask, stats = tres
    assert families is not None and stats["stream_frac"] > 0.5, stats
    sps = tuple(tsp.stream_plan_from_host(a, m) for a, m in families)
    x = rng.standard_normal((n, 96)).astype(np.float32)
    out = tapi._stream_sum(sps, torch.from_numpy(x))
    jout = japi._stream_sum(tuple(jsp.stream_plan_from_host(a, m) for a, m in families),
                            jnp.asarray(x))
    sm = ~rest_mask
    ref = _ref(src[sm], dst[sm], x, n, None if w is None else w[sm])
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


def test_stream_chunked_matches_reference():
    n = 2000
    src, dst = _clustered_edges(n, 40_000, 0, seed=2)
    kw = dict(max_chunk_tiles=8, build_edge_pos=True)
    tres = tsp.build_stream_split_host(dst, src, n, n, knobs=LOW_FRAC, uniformize=True, **kw)
    jres = jsp.build_stream_split_host(dst, src, n, n, min_stream_frac=0.05, **kw)
    _assert_split_equal(jres, tres)
    families, rest_mask, _ = tres
    assert any(len(m["chunks"]) > 2 for _, m in families)
    sps = tuple(tsp.stream_plan_from_host(a, m) for a, m in families)
    # uniformized pad tiles keep out_block non-decreasing over each family
    for sp in sps:
        ob = sp.out_block.numpy()
        assert (np.diff(ob) >= 0).all()
    x = np.random.default_rng(3).standard_normal((n, 64)).astype(np.float32)
    out = tapi._stream_sum(sps, torch.from_numpy(x))
    sm = ~rest_mask
    np.testing.assert_allclose(out.numpy(), _ref(src[sm], dst[sm], x, n), **TOL)


def test_stream_split_without_pads():
    """The port's own plans (no `uniformize`) are the reference's with the
    all -1 pad tiles taken out: the same real tiles in the same order, the
    same chunk windows, the same sums."""
    n = 2000
    src, dst = _clustered_edges(n, 40_000, 0, seed=2)
    kw = dict(max_chunk_tiles=8, knobs=LOW_FRAC)
    padded, rest_p, _ = tsp.build_stream_split_host(dst, src, n, n, uniformize=True, **kw)
    plain, rest_mask, stats = tsp.build_stream_split_host(dst, src, n, n, **kw)
    np.testing.assert_array_equal(rest_p, rest_mask)
    n_pads = 0
    for (ap, mp), (a, m) in zip(padded, plain):
        real = (ap["srcl3"] >= 0).any(axis=(1, 2))
        n_pads += int((~real).sum())
        assert (a["srcl3"] >= 0).any(axis=(1, 2)).all()
        for k in ap:
            np.testing.assert_array_equal(ap[k][real], a[k], err_msg=k)
        assert [c[2:] for c in mp["chunks"]] == [c[2:] for c in m["chunks"]]
        assert sum(c[1] - c[0] for c in m["chunks"]) == a["out_block"].shape[0]
        assert (mp["num_edges"], m["chunk_blocks"]) == (m["num_edges"], 0)
    assert n_pads > 0, "no chunk was padded"
    assert [f["n_tiles"] for f in stats["families"]] == [
        a["out_block"].shape[0] for a, _ in plain]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((n, 64)).astype(np.float32))
    outs = [tapi._stream_sum(tuple(tsp.stream_plan_from_host(a, m) for a, m in fams), x)
            for fams in (padded, plain)]
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), **TOL)


def test_mixed_tile_size_families():
    n, src, dst = _mixed_edges()
    tres = tsp.build_stream_split_host(dst, src, n, n, knobs=LOW_FRAC, uniformize=True)
    _assert_split_equal(jsp.build_stream_split_host(dst, src, n, n, min_stream_frac=0.05),
                        tres)
    families, rest_mask, stats = tres
    e_tiles = sorted(m["e_tile"] for _, m in families)
    assert len(e_tiles) >= 2 and e_tiles[-1] >= 4096, stats["families"]
    sps = tuple(tsp.stream_plan_from_host(a, m) for a, m in families)
    x = np.random.default_rng(9).standard_normal((n, 96)).astype(np.float32)
    out = tapi._stream_sum(sps, torch.from_numpy(x))
    sm = ~rest_mask
    np.testing.assert_allclose(out.numpy(), _ref(src[sm], dst[sm], x, n), **TOL)


def test_uniform_graph_skips_stream():
    n = 40_000
    rng = np.random.default_rng(8)
    src = rng.integers(0, n, 30_000).astype(np.int32)
    dst = np.sort(rng.integers(0, n, 30_000)).astype(np.int32)
    tres = tsp.build_stream_split_host(dst, src, n, n, uniformize=True)
    _assert_split_equal(jsp.build_stream_split_host(dst, src, n, n), tres)
    assert tres[0] is None and tres[1].all()
    kw = dict(TILES, feature_hint=128, layouts=("bat", "stream"))
    tg = tbuild_graph(src, dst, n, device="cpu", **kw)
    jg = jbuild_graph(src, dst, n, **kw)
    assert tg.hyb is None and tg.hyb_t is None and jg.hyb is None
    assert tapi.dispatch_path(tg) == japi.dispatch_path(jg, backend="pallas") == "bat"


@pytest.mark.parametrize("mixing", [0.2, 1.0])
def test_cell_census_matches_reference(mixing):
    g = jclustered(20_000, 400_000, mixing=mixing, mean_community=800, seed=0)
    for kw in ({}, dict(s_tile=128, x_rows=512)):
        assert tsp.cell_census(g.dst, g.src, **kw) == jsp.cell_census(g.dst, g.src, **kw)


@pytest.mark.parametrize("shuffle", [False, True])
def test_synthetic_clustered_graph_equal(shuffle):
    kw = dict(mixing=0.3, mean_community=500, feat_dim=8, num_classes=5,
              shuffle=shuffle, seed=4)
    j, t = jclustered(6000, 50_000, **kw), tclustered(6000, 50_000, **kw)
    for k in ("src", "dst", "x", "y", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(j, k), getattr(t, k), err_msg=k)
    assert (j.num_nodes, j.name) == (t.num_nodes, t.name)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["acc", "sum"])
def test_stream_kernels_plain_vs_pallas(mode, weighted):
    n, src, dst = _mixed_edges()
    rng = np.random.default_rng(2 + weighted)
    w = rng.standard_normal(len(src)).astype(np.float32) if weighted else None
    families, _, _ = tsp.build_stream_split_host(dst, src, n, n, edge_weight=w,
                                                 knobs=LOW_FRAC)
    for arrays, meta in families:
        sp = tsp.stream_plan_from_host(arrays, meta)
        s, xr = meta["s_tile"], meta["x_rows"]
        # the port's x needs no padding: 40 columns, rows to n only
        x = rng.standard_normal((n, 40)).astype(np.float32)
        xj = np.zeros((meta["n_xblocks"] * xr, 128), np.float32)
        xj[:n, :40] = x
        args = (jnp.asarray(arrays["out_block"]), jnp.asarray(arrays["sblock"]),
                jnp.asarray(arrays["dst3"]), jnp.asarray(arrays["srcl3"]),
                jnp.asarray(xj))
        w3 = jnp.asarray(arrays["w3"]) if weighted else None
        rows = meta["n_blocks"] * s
        if mode == "acc":
            carry = rng.standard_normal((rows, 40)).astype(np.float32)
            carry_j = np.zeros((rows, 128), np.float32)
            carry_j[:, :40] = carry
            j = jstream_acc(*args, jnp.asarray(carry_j), w3, s_tile=s, x_rows=xr,
                            interpret=True)
            t = stream_segment_acc(sp, torch.from_numpy(x), torch.from_numpy(carry.copy()))
            np.testing.assert_allclose(t.numpy(), np.asarray(j)[:, :40], **TOL)
            p = stream_segment_acc_plain(sp, torch.from_numpy(x), torch.from_numpy(carry))
            torch.testing.assert_close(t, p, rtol=0, atol=0)
        else:
            j = np.asarray(jstream_sum(*args, w3, s_tile=s, x_rows=xr,
                                       n_blocks=meta["n_blocks"], interpret=True))
            t = stream_segment_sum(sp, torch.from_numpy(x))
            assert t.shape == (rows, 40) and t.dtype == torch.float32
            # the Pallas kernel leaves windows no tile visits unwritten; the
            # port writes zeros there
            visited = np.zeros(meta["n_blocks"], bool)
            visited[arrays["out_block"]] = True
            vrows = np.repeat(visited, s)
            np.testing.assert_allclose(t.numpy()[vrows], j[vrows, :40], **TOL)
            assert not t.numpy()[~vrows].any()
            torch.testing.assert_close(t, stream_segment_sum_plain(sp, torch.from_numpy(x)),
                                       rtol=0, atol=0)


def _schedule_brute(ob, sb, dst3, srcl3, w3, s_tile, x_rows, slice_slots):
    """The kernel's live slots and units, built slot by slot: each row's
    live slots in slot order, cut into ceil(n / slice_slots) near-equal
    slices when longer than slice_slots."""
    T, E = dst3.shape[0], dst3.shape[-1]
    by_row = {}
    for t in range(T):
        for e in range(E):
            d = int(dst3.reshape(T, E)[t, e]) - int(ob[t]) * s_tile
            s = int(srcl3.reshape(T, E)[t, e])
            if 0 <= s < x_rows and 0 <= d < s_tile:
                w = 1.0 if w3 is None else float(w3.reshape(T, E)[t, e])
                by_row.setdefault(int(ob[t]) * s_tile + d, []).append(
                    (int(sb[t]) * x_rows + s, w))
    cols, vals, dest, n_parts = [], [], [], 0
    for r in sorted(by_row):
        terms = by_row[r]
        k = -(-len(terms) // slice_slots)
        sizes = [len(terms) // k + (i < len(terms) % k) for i in range(k)]
        i = 0
        for size in sizes:
            unit = terms[i:i + size]
            i += size
            cols += [c for c, _ in unit[:-1]] + [unit[-1][0] | (1 << 31)]
            vals += [v for _, v in unit]
            dest.append(r if k == 1 else -(n_parts + 1))
            n_parts += k > 1
    return (np.array(cols, np.int64).astype(np.uint32).view(np.int32),
            np.array(vals, np.float32), np.array(dest, np.int32), by_row)


def _walk(sched, x, n_out, carry=None):
    """The kernel's sums in its order, in float32: each unit's slots in
    order from 0, the fix-up levels in order, each entry's partials in
    order; in accumulate mode the row's old value plus that sum. Returns
    the output and how often each row was written."""
    cols = sched["cols"].view(np.uint32).astype(np.int64)
    rows = cols & 0x7FFFFFFF
    v = np.zeros((len(rows), x.shape[1]), np.float32)
    ok = rows < x.shape[0]  # x rows past the end read as zero
    v[ok] = x[rows[ok]]
    if sched["vals"] is not None:
        v *= sched["vals"][:, None]
    part = np.zeros((sched["n_parts"], x.shape[1]), np.float32)
    out = np.zeros((n_out, x.shape[1]), np.float32) if carry is None else carry.copy()
    written = np.zeros(n_out, np.int64)

    def ordered_sum(vecs, first, count):
        acc = np.zeros((len(first), vecs.shape[1]), np.float32)
        for i in range(int(count.max(initial=0))):
            m = count > i
            acc[m] = acc[m] + vecs[first[m] + i]
        return acc

    def put(dest, acc):
        fin = dest >= 0
        out[dest[fin]] = acc[fin] if carry is None else carry[dest[fin]] + acc[fin]
        np.add.at(written, dest[fin], 1)
        part[-dest[~fin] - 1] = acc[~fin]

    ends = np.flatnonzero(cols >> 31) + 1
    starts = np.concatenate([[0], ends[:-1]]).astype(np.int64)
    put(sched["unit_dest"], ordered_sum(v, starts, ends - starts))
    lv = sched["fix_levels"]
    for lo, hi in zip(lv[:-1], lv[1:]):
        e = sched["fix"][lo:hi].astype(np.int64)
        put(e[:, 0], ordered_sum(part, e[:, 1], e[:, 2] - e[:, 1]))
    for r0, cnt in sched["zero_runs"]:
        written[r0:r0 + cnt] += 1
    return out, written


def _check_schedule(ob, sb, dst3, srcl3, w3, s_tile, x_rows, n_blocks, **knobs):
    """kernel_schedule's arrays against the slot-by-slot build, and its
    tasks and fix-up tree against their rules. Returns the schedule."""
    sched = tsp.kernel_schedule(ob, sb, dst3, srcl3, w3, s_tile, x_rows, n_blocks, **knobs)
    L = knobs.get("slice_slots", tsp.SLICE_SLOTS)
    cols, vals, dest, by_row = _schedule_brute(ob, sb, dst3, srcl3, w3, s_tile, x_rows, L)
    np.testing.assert_array_equal(sched["cols"], cols)
    np.testing.assert_array_equal(sched["unit_dest"], dest)
    if w3 is None:
        assert sched["vals"] is None
    else:
        np.testing.assert_array_equal(sched["vals"], vals)
    # tasks: contiguous, covering every slot, unit and zero run once
    tasks = sched["tasks"].astype(np.int64)
    assert (np.diff(tasks, axis=0) >= 0).all()
    assert tasks[0].tolist() == [0, 0, 0]
    assert tasks[-1].tolist() == [len(cols), len(dest), len(sched["zero_runs"])]
    ends = np.flatnonzero(cols.view(np.uint32) >> 31) + 1
    u_first_slot = np.concatenate([[0], ends[:-1]])
    np.testing.assert_array_equal(u_first_slot[tasks[:-1, 1][tasks[:-1, 1] < len(dest)]],
                                  tasks[:-1, 0][tasks[:-1, 1] < len(dest)])
    # a task's cost stays under task_cost plus one element's
    cost_cap = knobs.get("task_cost", tsp.TASK_COST) + L + tsp.UNIT_COST
    z = sched["zero_runs"].astype(np.int64)
    zr = np.concatenate([[0], np.cumsum(z[:, 1])])
    for t in range(len(tasks) - 1):
        slots = tasks[t + 1, 0] - tasks[t, 0]
        units = tasks[t + 1, 1] - tasks[t, 1]
        zeros = zr[tasks[t + 1, 2]] - zr[tasks[t, 2]]
        assert slots + units * tsp.UNIT_COST + zeros * tsp.ZERO_COST <= cost_cap
    # the fix-up: each level reads only partials written before it, at most
    # fix_fanin at a time
    fix, lv = sched["fix"].astype(np.int64), sched["fix_levels"]
    assert lv[0] == 0 and lv[-1] == len(fix)
    assert ((fix[:, 2] - fix[:, 1] >= 1)
            & (fix[:, 2] - fix[:, 1] <= knobs.get("fix_fanin", tsp.FIX_FANIN))).all()
    ready = int((dest < 0).sum())
    for lo, hi in zip(lv[:-1], lv[1:]):
        assert (fix[lo:hi, 2] <= ready).all()
        ready += int((fix[lo:hi, 0] < 0).sum())
    assert ready == sched["n_parts"]
    # every output row is written exactly once in the sum mode
    _, written = _walk(sched, np.zeros((1, 1), np.float32), n_blocks * s_tile)
    assert (written == 1).all()
    return sched


def test_kernel_schedule_splits_windows_and_refuses_disorder():
    # windows 0 (5 tiles), 2 (1 tile) and 3 (2 tiles); 1 and 4 unvisited;
    # E = 256, s_tile = 8, x_rows = 16
    ob = np.array([0, 0, 0, 0, 0, 2, 3, 3], np.int32)
    sb = np.array([0, 2, 1, 1, 0, 2, 1, 0], np.int32)
    rng = np.random.default_rng(0)
    dst = ob[:, None] * 8 + rng.integers(0, 8, (8, 256))
    dst[0:3] = 5  # row 5 of window 0: a hub of 768 + ~64 slots
    dst[6, :200] = 3 * 8 + 1  # row 1 of window 3: 200 of 512 slots
    dst[1, 7] = 8  # a slot of window 1 in a tile of window 0: not added
    srcl = rng.integers(0, 16, (8, 256))
    srcl[7, 100:] = -1  # padding
    srcl[2, 3] = 16  # past the block: not added
    w = rng.standard_normal((8, 256)).astype(np.float32)
    w[0, 10] = w[0, 200] = 0.0  # real edges of weight 0 inside the hub's run
    args = (ob, sb, dst[:, None].astype(np.int32), srcl[:, None].astype(np.int32))
    sched = _check_schedule(*args, w[:, None], 8, 16, 5, slice_slots=256, task_cost=512)
    # the hub row alone is cut, into four near-equal slices, then summed in
    # one fix-up entry; window 0's rows fall in several tasks
    assert sched["n_parts"] == 4 and sched["fix"].tolist() == [[5, 0, 4]]
    assert len(sched["tasks"]) - 1 > 2
    # weights of 0 are kept: the kernel adds 0 * x as the TPU kernel does
    assert (sched["vals"] == 0).sum() == 2
    # zeros: windows 1 and 4 and the other empty rows, in runs
    z = sched["zero_runs"]
    empty = np.concatenate([np.arange(r, r + c) for r, c in z])
    assert {8, 9, 15, 32, 39} <= set(empty.tolist())
    assert not set(empty.tolist()) & set(np.unique(dst[srcl >= 0]).tolist()) - {8}
    # a tree of fix-up levels: 832 slots in slices of 4, added 2 at a time
    deep = _check_schedule(*args, None, 8, 16, 5, slice_slots=4, fix_fanin=2, task_cost=16)
    assert len(deep["fix_levels"]) - 1 >= 8
    with pytest.raises(ValueError, match="non-decreasing"):
        tsp.kernel_schedule(ob[::-1].copy(), sb, *args[2:], None, 8, 16, 5)
    with pytest.raises(ValueError, match="outside"):
        tsp.kernel_schedule(*args, None, 8, 16, 3)


@pytest.mark.parametrize("knobs", [{}, dict(slice_slots=8, fix_fanin=3, task_cost=64)])
def test_kernel_schedule_matches_brute_force(knobs):
    """On the test graphs' real families: the mixed-family graph (one
    4000-edge cell) and the clustered one, weighted, with every fifth
    weight 0."""
    n, src, dst = _mixed_edges()
    graphs = [(n, src, dst)]
    s2, d2 = _clustered_edges(1500, 30_000, 3_000)
    graphs.append((1500, s2, d2))
    for n, src, dst in graphs:
        w = np.random.default_rng(5).standard_normal(len(src)).astype(np.float32)
        w[::5] = 0.0
        families, _, _ = tsp.build_stream_split_host(dst, src, n, n, edge_weight=w,
                                                     knobs=LOW_FRAC)
        for arrays, meta in families:
            _check_schedule(arrays["out_block"], arrays["sblock"], arrays["dst3"],
                            arrays["srcl3"], arrays["w3"], meta["s_tile"], meta["x_rows"],
                            meta["n_blocks"], **knobs)


@pytest.mark.parametrize("knobs", [{}, dict(slice_slots=8, fix_fanin=3, task_cost=64)])
@pytest.mark.parametrize("mode", ["acc", "sum"])
def test_schedule_order_vs_pallas(mode, knobs):
    """The kernel's order of summation, walked in numpy, against JAX's
    stream kernels in interpret mode."""
    n, src, dst = _mixed_edges()
    rng = np.random.default_rng(11)
    w = rng.standard_normal(len(src)).astype(np.float32)
    w[::7] = 0.0
    families, _, _ = tsp.build_stream_split_host(dst, src, n, n, edge_weight=w,
                                                 knobs=LOW_FRAC)
    for arrays, meta in families:
        s, xr, nb = meta["s_tile"], meta["x_rows"], meta["n_blocks"]
        sched = tsp.kernel_schedule(arrays["out_block"], arrays["sblock"], arrays["dst3"],
                                    arrays["srcl3"], arrays["w3"], s, xr, nb, **knobs)
        x = rng.standard_normal((n - 100, 40)).astype(np.float32)  # ends mid-block
        xj = np.zeros((meta["n_xblocks"] * xr, 128), np.float32)
        xj[:n - 100, :40] = x
        args = (jnp.asarray(arrays["out_block"]), jnp.asarray(arrays["sblock"]),
                jnp.asarray(arrays["dst3"]), jnp.asarray(arrays["srcl3"]), jnp.asarray(xj))
        w3 = jnp.asarray(arrays["w3"])
        if mode == "acc":
            carry = rng.standard_normal((nb * s, 40)).astype(np.float32)
            carry_j = np.zeros((nb * s, 128), np.float32)
            carry_j[:, :40] = carry
            j = np.asarray(jstream_acc(*args, jnp.asarray(carry_j), w3, s_tile=s, x_rows=xr,
                                       interpret=True))[:, :40]
            got, _ = _walk(sched, x, nb * s, carry)
        else:
            j = np.asarray(jstream_sum(*args, w3, s_tile=s, x_rows=xr, n_blocks=nb,
                                       interpret=True))[:, :40]
            got, _ = _walk(sched, x, nb * s)
            visited = np.repeat(np.isin(np.arange(nb), arrays["out_block"]), s)
            assert not got[~visited].any()
            got, j = got[visited], j[visited]
        np.testing.assert_allclose(got, j, **TOL)


def _graph_pair(weighted, seed=6, n=1200, layouts=("bat", "stream")):
    src, dst = _clustered_edges(n, 20_000, 2_000, seed=seed)
    rng = np.random.default_rng(seed + 1)
    w = (rng.standard_normal(len(src)) ** 2 + 0.1).astype(np.float32) if weighted else None
    args = dict(TILES, feature_hint=96, layouts=layouts)
    jg = jbuild_graph(src, dst, n, edge_weight=w, **args)
    tg = tbuild_graph(src, dst, n, edge_weight=w, device="cpu", **args)
    return jg, tg, rng


@pytest.mark.parametrize("weighted", [False, True])
def test_build_graph_hybrid_matches_reference(weighted):
    jg, tg, _ = _graph_pair(weighted)
    for jh, th in ((jg.hyb, tg.hyb), (jg.hyb_t, tg.hyb_t)):
        assert jh is not None and th is not None
        assert len(jh.stream) == len(th.stream)
        for js, ts in zip(jh.stream, th.stream):
            # the port's plans leave out the reference's all -1 pad tiles
            real = (np.asarray(js.srcl3) >= 0).any(axis=(1, 2))
            for k in ("out_block", "sblock", "dst3", "srcl3") + (("w3",) if weighted else ()):
                np.testing.assert_array_equal(np.asarray(getattr(js, k))[real],
                                              getattr(ts, k).numpy(), err_msg=k)
            assert [c[2:] for c in js.chunks] == [c[2:] for c in ts.chunks]
            assert (js.e_tile, js.num_edges) == (ts.e_tile, ts.num_edges)
        assert (jh.rest is None) == (th.rest is None)
        np.testing.assert_array_equal(np.asarray(jh.rest_src), th.rest_src.numpy())
        np.testing.assert_array_equal(np.asarray(jh.rest.vblock), th.rest.vblock.numpy())
        assert jh.rest.chunks == th.rest.chunks
        assert (jh.rest_w is None) == (th.rest_w is None) == (not weighted)
    assert tapi.dispatch_path(tg) == japi.dispatch_path(jg, backend="pallas") == "hybrid"
    fwd = tg.build_stats["stream"]["forward"]
    assert fwd["rest_edges"] == tg.hyb.rest.num_edges and 0 < fwd["stream_frac"] < 1
    assert {"stream_split_forward", "stream_split_transpose"} <= set(tg.build_stats["seconds"])
    # per-call weights and the reference backend leave the hybrid path, as
    # in the reference
    assert tapi.dispatch_path(tg, dynamic_w=True) == "bat_dyn"
    assert tapi.dispatch_path(tg, backend="reference") == "xla"


@pytest.mark.parametrize("weighted", [False, True])
def test_hybrid_segment_spmm_and_grad_vs_jax(weighted):
    jg, tg, rng = _graph_pair(weighted)
    n = tg.num_nodes
    x = rng.standard_normal((n, 96)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    out = tapi.segment_spmm(tg, xt)
    jout = japi.segment_spmm(jg, jnp.asarray(x), backend="pallas")
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    w = None if tg.edge_weight is None else tg.edge_weight.numpy()
    np.testing.assert_allclose(out.detach().numpy(),
                               _ref(tg.src.numpy(), tg.dst.numpy(), x, n, w), **TOL)
    cot = rng.standard_normal(out.shape).astype(np.float32)
    (out * torch.from_numpy(cot)).sum().backward()
    jgrad = jax.grad(lambda xx: jnp.vdot(japi.segment_spmm(jg, xx, backend="pallas"),
                                         jnp.asarray(cot)))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), **TOL)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_gather_scatter_hybrid_vs_jax(reduce):
    jg, tg, rng = _graph_pair(False, seed=12)
    n = tg.num_nodes
    x = rng.standard_normal((n, 130)).astype(np.float32)
    t = tapi.gather_scatter(tg.src, tg.dst, torch.from_numpy(x), n, reduce=reduce, graph=tg)
    j = japi.gather_scatter(jg.src, jg.dst, jnp.asarray(x), n, reduce=reduce, graph=jg,
                            backend="pallas")
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    # a stream-only graph (no BAT plan) takes its mean's degree from dst
    to = tbuild_graph(tg.src.numpy(), tg.dst.numpy(), n, device="cpu", feature_hint=96,
                      layouts=("stream",), **TILES)
    assert to.bat is None and to.hyb is not None
    t2 = tapi.gather_scatter(to.src, to.dst, torch.from_numpy(x), n, reduce=reduce, graph=to)
    np.testing.assert_allclose(t2.numpy(), t.numpy(), **TOL)


@pytest.mark.parametrize("path", ["bat", "hybrid"])
def test_bf16_segment_spmm_vs_jax(path):
    """bfloat16 in, bfloat16 out, float32 sums (ROADMAP C.2), over the BAT
    path and the hybrid path, against JAX on the same inputs."""
    layouts = ("bat", "stream") if path == "hybrid" else ("bat",)
    jg, tg, rng = _graph_pair(True, layouts=layouts)
    assert tapi.dispatch_path(tg) == japi.dispatch_path(jg, backend="pallas") == (
        "hybrid" if path == "hybrid" else "bat_static")
    x = rng.standard_normal((1200, 96)).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    t = tapi.segment_spmm(tg, xb)
    assert t.dtype == torch.bfloat16
    j = japi.segment_spmm(jg, jnp.asarray(x).astype(jnp.bfloat16), backend="pallas")
    assert j.dtype == jnp.bfloat16
    ref = _ref(tg.src.numpy(), tg.dst.numpy(), xb.float().numpy(), 1200,
               w=tg.edge_weight.numpy())
    np.testing.assert_allclose(t.float().numpy(), ref, **TOL_BF16)
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **TOL_BF16)
    # the other fused ops keep the dtype too
    ones = torch.ones(tg.num_edges)
    assert tapi.gather_weight_scatter(tg.src, tg.dst, ones, xb, 1200, graph=tg).dtype == \
        torch.bfloat16
    assert tapi.gather_scatter(tg.src, tg.dst, xb, 1200, graph=tg).dtype == torch.bfloat16
    assert tapi.index_scatter(xb[tg.src.long()], tg.dst, 1200, plan=tg.bat).dtype == \
        torch.bfloat16


def test_hyb_and_hyb_t_are_none_together(monkeypatch):
    """The forward streams and the transpose does not: both stay on the
    gather path, since the backward needs the transpose pair."""
    real = tstructures.build_stream_split_host
    calls = []

    def forward_only(*args, **kwargs):
        calls.append(1)
        res = real(*args, **kwargs)
        return res if len(calls) == 1 else (None, np.ones(len(args[0]), bool), {})

    monkeypatch.setattr(tstructures, "build_stream_split_host", forward_only)
    _, tg, _ = _graph_pair(True)
    assert len(calls) == 2
    assert tg.hyb is None and tg.hyb_t is None
    assert tapi.dispatch_path(tg) == "bat_static"


def test_stream_plan_to_device_and_knobs():
    n = 1500
    src, dst = _clustered_edges(n, 30_000, 3_000)
    families, _, _ = tsp.build_stream_split_host(dst, src, n, n, knobs=LOW_FRAC)
    sp = tsp.stream_plan_from_host(*families[0])
    moved = sp.to(torch.device("cpu"))
    for k in ("out_block", "sblock", "dst3", "srcl3", "cols", "unit_dest", "tasks",
              "zero_runs", "fix"):
        torch.testing.assert_close(getattr(moved, k), getattr(sp, k), rtol=0, atol=0)
    assert moved.vals is None and sp.vals is None
    assert (moved.e_tile, moved.n_parts, moved.fix_levels, moved.chunks) == (
        sp.e_tile, sp.n_parts, sp.fix_levels, sp.chunks)
    # the default knobs are the reference's constants
    knobs = tsp.StreamKnobs()
    assert dict(knobs.tile_ns) == jsp.TILE_NS
    assert (knobs.fixed_ns, knobs.marg_ns, knobs.e_choices) == (
        jsp.FIXED_NS, jsp.MARG_NS, jsp.E_CHOICES)
    # a knob changes the split: a margin no split can beat rejects streaming
    big = np.tile(np.arange(400, dtype=np.int64), 600)
    d = np.sort(big)
    assert tsp.build_stream_split_host(d, big, 400, 400)[0] is not None
    strict = tsp.StreamKnobs(margin=0.0, margin_min_edges=0)
    assert tsp.build_stream_split_host(d, big, 400, 400, knobs=strict)[0] is None
