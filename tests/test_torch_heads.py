"""The wide slot sum (`plan_segment_sum_sr`) and the multi-head slot sum
(`plan_segment_sum_mh`) as callers of the edge-row kernel, against the JAX
package.

- A numpy walk in the edge-row kernel's order (entries, slices, fix-up
  levels; `ops/csrc/edge_row_sum.cu`), each entry resolved as the kernel
  does with per-head weights (a head looked up per column, an entry
  skipped only where all its H weights are 0), against JAX's
  `plan_segment_sum_mh` in interpret mode at (H, D) = (4, 64), (4, 7),
  (3, 96), (8, 32), weights exactly 0 on chosen heads; and with one weight
  per entry against JAX's `plan_segment_sum_sr` at F 256 and 130 (JAX
  takes F % 128 == 0: its rows are padded to 256 and the real columns
  compared). Both forms: slot-order values, and x[src[e]] read in the
  kernel with the weights in the plan's edge order. Tolerance
  1e-4 * sum|terms| + 1e-5 per element (the Pallas f32 kernels multiply
  through a bf16 hi/lo split).
- The plain gathered forms against the values forms, whole and chunked,
  with rows past x's end reading as zero.
- The routes: `slot` / `slot_static` past 64 columns and `mh_spmm` /
  `gat_attention_spmm` (both of its routes) hand the kernel x and src,
  one call a plan, chunked or not, against JAX with every gradient at the
  tolerances of tests/test_torch_slot.py and tests/test_torch_mh.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geot_tpu.graph import plan as jplan
from geot_tpu.graph.structures import build_graph as jbuild_graph
from geot_tpu.models.conv import prepare_graph as jprepare_graph
from geot_tpu.ops import api as japi
from geot_tpu.ops import pallas_segment as jps
from geot_tpu_torch.graph import plan as tplan
from geot_tpu_torch.graph.structures import build_graph as tbuild_graph
from geot_tpu_torch.models import prepare_graph
from geot_tpu_torch.ops import api as tapi
from geot_tpu_torch.ops import reference as tref

TOL = dict(rtol=2e-4, atol=2e-4)
TOL_GAT = dict(rtol=1e-4, atol=1e-4)
TOL_GAT_GRAD = dict(rtol=1e-3, atol=1e-4)
SMALL = dict(slice_slots=4, fix_fanin=2, task_cost=16)
HD = [(4, 64), (4, 7), (3, 96), (8, 32)]


def _hubby_sorted(rng, n, nnz, hub_edges, hub=7):
    dst = np.concatenate([np.full(hub_edges, hub, np.int32),
                          rng.integers(0, n, nnz).astype(np.int32)])
    src = rng.integers(0, n, len(dst)).astype(np.int32)
    order = np.argsort(dst, kind="stable")
    return src[order], dst[order]


def _plans(rng, n=400, e_tile=64, pack_align=1):
    src, dst = _hubby_sorted(rng, n, 1500, 500)
    kw = dict(e_tile=e_tile, s_tile=128, pack_align=pack_align, num_src_nodes=n)
    return (jplan.build_segment_plan(dst, src, n + 100, **kw),
            tplan.build_segment_plan(dst, src, n + 100, **kw, device="cpu"), src, dst)


def _np(t):
    return t.cpu().numpy()


def _walk(s, vals, w_cols, live):
    """The edge-row kernel's sums in its order, in float32: entry i adds
    w_cols[i] * vals[i] (rows [S, F] in schedule order) where live[i], each
    unit's entries in order from 0, the fix-up levels in order, each
    entry's partials in order. Returns [n_out, F]."""
    cols = _np(s.cols).view(np.uint32).astype(np.int64)
    terms = np.where(live[:, None], w_cols * vals, 0).astype(np.float32)
    F = vals.shape[1]
    part = np.zeros((s.n_parts, F), np.float32)
    out = np.full((s.n_out, F), np.nan, np.float32)

    def ordered_sum(vecs, first, count):
        acc = np.zeros((len(first), F), np.float32)
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


def _entries(s, x, src, by_slot):
    """Each schedule entry's edge, slot, value row (zeros where it lies
    outside x) and whether that row exists: slot order (x in slot order)
    or gathered (x[src[e]])."""
    e = _np(s.cols).view(np.uint32).astype(np.int64) & 0x7FFFFFFF
    slot = _np(s.slot).astype(np.int64)
    r = slot if by_slot else np.where(e < len(src), src[np.minimum(e, len(src) - 1)], -1)
    inside = (r >= 0) & (r < x.shape[0])
    v = np.zeros((len(e), x.shape[1]), np.float32)
    v[inside] = x[r[inside]]
    return e, slot, v, inside


def _walk_mh(s, x, w_heads, head_dim, *, src=None):
    """mh in the kernel's order: the weight row of an entry is its slot
    (values in slot order, src None) or its edge (gathered); column c takes
    head c // head_dim (0 past H); an entry is skipped only where all its
    H weights are 0 (or its weight row lies past w_heads' end)."""
    e, slot, v, inside = _entries(s, x, src, src is None)
    hid = slot if src is None else e
    H = w_heads.shape[1]
    wh = np.zeros((len(e), H), np.float32)
    ok = hid < w_heads.shape[0]
    wh[ok] = w_heads[hid[ok]]
    head = np.arange(x.shape[1]) // head_dim
    w_cols = np.zeros((len(e), x.shape[1]), np.float32)
    w_cols[:, head < H] = wh[:, head[head < H]]
    return _walk(s, v, w_cols, inside & (wh != 0).any(axis=1))


def _walk_sr(s, x, w_slots, *, src=None):
    """sr in the kernel's order: one weight per entry, its slot's; an entry
    of weight 0 is skipped."""
    e, slot, v, inside = _entries(s, x, src, src is None)
    w = w_slots.reshape(-1)[slot].astype(np.float32)
    return _walk(s, v, np.repeat(w[:, None], x.shape[1], axis=1), inside & (w != 0))


def _head_weights(rng, plan, H):
    """[nnz, H] edge-order head weights with heads 0 and 2 exactly 0 on
    every third edge and every head 0 on every seventh; and their slot-order
    copy [T*E, H] (0 on pads: the TPU kernel's contract)."""
    nnz = plan.num_edges
    we = rng.standard_normal((nnz, H)).astype(np.float32)
    third = (np.arange(nnz) % 3 == 1)[:, None] & (np.arange(H) % 2 == 0)[None, :]
    we[third] = 0.0
    we[np.arange(nnz) % 7 == 3] = 0.0
    mask = _np(plan.mask).reshape(-1, 1)
    ws = (we[_np(plan.edge_pos).reshape(-1)] * mask).astype(np.float32)
    return we, ws


def _assert_abs_sum(t, j, a):
    bad = np.abs(t - j) > 1e-4 * a + 1e-5
    assert not bad.any(), (int(bad.sum()), float(np.abs(t - j).max()))


@pytest.mark.parametrize("knobs", [{}, SMALL])
@pytest.mark.parametrize("H,D", HD)
@pytest.mark.parametrize("form", ["values", "gathered"])
def test_walk_mh_vs_pallas(knobs, H, D, form):
    """The kernel's order with per-head weights against JAX's
    plan_segment_sum_mh in interpret mode on the same plan: values in slot
    order with slot-order weights, or x[src[e]] with the weights in the
    plan's edge order."""
    rng = np.random.default_rng(H * 100 + D + len(form) + len(knobs))
    jp, tp, src, dst = _plans(rng)
    if knobs:
        tp = tplan.with_row_schedule(tp, **knobs)
    F = H * D
    x = rng.standard_normal((400, F)).astype(np.float32)
    we, ws = _head_weights(rng, tp, H)
    v = x[_np(tp.src_slots).reshape(-1)]
    f_pad = F if (F < 128 and F % 8 == 0) else -(-F // 128) * 128
    j = np.asarray(jps.plan_segment_sum_mh(jp, jnp.asarray(np.pad(v, ((0, 0), (0, f_pad - F)))),
                                           jnp.asarray(ws), D, interpret=True))[:, :F]
    if form == "gathered":
        got = _walk_mh(tp.row_sched, x, we, D, src=src)
    else:
        got = _walk_mh(tp.row_sched, v, ws, D)
    a = tref.plan_segment_sum_mh_plain(tp, torch.from_numpy(np.abs(v)),
                                       torch.from_numpy(np.abs(ws)), D).numpy()
    assert got.shape == j.shape == (tp.n_blocks * tp.s_tile, F)
    _assert_abs_sum(got, j, a)


@pytest.mark.parametrize("knobs", [{}, SMALL])
@pytest.mark.parametrize("F", [256, 130])
@pytest.mark.parametrize("form", ["values", "gathered"])
def test_walk_sr_vs_pallas(knobs, F, form):
    """The kernel's order with one weight per slot (every fifth 0: skipped)
    against JAX's plan_segment_sum_sr in interpret mode; JAX's rows padded
    to a multiple of 128 columns, the real ones compared."""
    rng = np.random.default_rng(F + len(form) + len(knobs))
    jp, tp, src, dst = _plans(rng, pack_align=16)
    if knobs:
        tp = tplan.with_row_schedule(tp, **knobs)
    T, E = tp.num_tiles, tp.e_tile
    ws = (_np(tp.mask) * rng.standard_normal((T, E))).astype(np.float32)
    ws.reshape(-1)[::5] = 0.0
    x = rng.standard_normal((400, F)).astype(np.float32)
    v = x[_np(tp.src_slots).reshape(-1)]
    f_pad = -(-F // 128) * 128
    j = np.asarray(jps.plan_segment_sum_sr(
        jp, jnp.asarray(np.pad(v, ((0, 0), (0, f_pad - F)))), jnp.asarray(ws),
        f_tile=256 if f_pad % 256 == 0 else 128, interpret=True))[:, :F]
    got = (_walk_sr(tp.row_sched, x, ws, src=src) if form == "gathered"
           else _walk_sr(tp.row_sched, v, ws))
    a = tref.plan_segment_sum_sr_plain(tp, torch.from_numpy(np.abs(v)),
                                       torch.from_numpy(np.abs(ws))).numpy()
    _assert_abs_sum(got, j, a)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("kernel", ["sr", "mh"])
def test_plain_gathered_forms_match_values_forms(chunked, kernel):
    """plan_segment_sum_sr_plain / plan_segment_sum_mh_plain with `src`
    (node rows read as x[src[e]], mh's weights in edge order) equal the
    values forms over x[src_slots] (mh: the weights placed by edge_pos,
    pads 0), whole and on a plan cut into uniformized chunks; node rows past
    x's end read as zero in both. Both sum the same terms in the same
    order (index_add_ over the kept slots), so they agree to rounding."""
    rng = np.random.default_rng(31 + chunked + len(kernel))
    n = 300
    src, dst = _hubby_sorted(rng, n, 2000, 700, hub=9)
    g = tbuild_graph(src, dst, n, e_tile=64, s_tile=64, layouts=("slot",), device="cpu",
                     assume_sorted=True, max_chunk_slots=64 * 4 if chunked else 4 << 20)
    assert bool(g.plan.chunks) == chunked
    for plan, src_e in ((g.plan, g.src), (g.plan_t, g.dst_t)):
        x = torch.from_numpy(rng.standard_normal((n - 40, 24)).astype(np.float32))
        ss = plan.src_slots.reshape(-1).long()
        vals = torch.where((ss < x.shape[0])[:, None], x[ss.clamp(max=x.shape[0] - 1)], 0.0)
        if kernel == "sr":
            ws = plan.mask * torch.from_numpy(rng.standard_normal(plan.mask.shape)
                                              .astype(np.float32))
            ws.reshape(-1)[::4] = 0.0
            got = tref.plan_segment_sum_sr_plain(plan, x, ws, src=src_e)
            want = tref.plan_segment_sum_sr_plain(plan, vals, ws)
        else:
            we, wsl = (torch.from_numpy(a) for a in _head_weights(rng, plan, 3))
            got = tref.plan_segment_sum_mh_plain(plan, x, we, 8, src=src_e)
            want = tref.plan_segment_sum_mh_plain(plan, vals, wsl, 8)
        assert got.shape == want.shape == (plan.n_blocks * plan.s_tile, 24)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def _record(monkeypatch, name):
    """Wrap ops.api's `name` to record whether each call passed src."""
    calls = []
    fn = getattr(tapi, name)

    def spy(*a, **kw):
        calls.append(kw.get("src") is not None)
        return fn(*a, **kw)

    monkeypatch.setattr(tapi, name, spy)
    return calls


@pytest.mark.parametrize("path", ["slot", "slot_static"])
@pytest.mark.parametrize("n_feat", [100, 130, 256])
@pytest.mark.parametrize("chunked", [False, True])
def test_wide_slot_routes_read_x_in_kernel(monkeypatch, path, n_feat, chunked):
    """The slot routes past 64 columns hand `plan_segment_sum_sr` x and the
    plan's edge-order src, one call a plan (forward over `plan`, dx over
    `plan_t`), chunked or not, with no slot-order gather. Forward and x
    gradient against a float64 numpy sum at rtol/atol 2e-4, and against
    JAX's segment_spmm and its x gradient at 1e-4 * sum|terms| + 1e-5 (the
    500-edge hub row reaches past 2e-4 in JAX's bf16 hi/lo products)."""
    rng = np.random.default_rng(n_feat + len(path) + chunked)
    n = 200
    src, dst = _hubby_sorted(rng, n, 1200, 500, hub=5)
    w_graph = (rng.random(len(dst)) + 0.1).astype(np.float32) if path == "slot_static" else None
    kw = dict(e_tile=64, s_tile=64, bat_e_tile=64, bat_s_tile=32, feature_hint=128,
              layouts=("slot",))
    jg = jbuild_graph(src, dst, n, edge_weight=w_graph, **kw)
    tg = tbuild_graph(src, dst, n, edge_weight=w_graph, device="cpu",
                      max_chunk_slots=64 * 4 if chunked else 4 << 20, **kw)
    assert bool(tg.plan.chunks) == chunked
    assert tapi.dispatch_path(tg) == japi.dispatch_path(jg, backend="pallas") == path
    calls = _record(monkeypatch, "plan_segment_sum_sr")
    x = rng.standard_normal((n, n_feat)).astype(np.float32)
    cot = rng.standard_normal((n, n_feat)).astype(np.float32)
    j, jvjp = jax.vjp(lambda xx: japi.segment_spmm(jg, xx, backend="pallas"), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tapi.segment_spmm(tg, xt)
    out.backward(torch.from_numpy(cot))
    assert calls == [True, True]
    w = np.ones(len(dst)) if w_graph is None else w_graph.astype(np.float64)
    for got, jv, a, to, fro in ((out.detach().numpy(), j, x, dst, src),
                                (xt.grad.numpy(), jvjp(jnp.asarray(cot))[0], cot, src, dst)):
        exact, abs_sum = np.zeros((n, n_feat)), np.zeros((n, n_feat))
        np.add.at(exact, to, w[:, None] * a[fro])
        np.add.at(abs_sum, to, np.abs(w[:, None] * a[fro]))
        np.testing.assert_allclose(got, exact, **TOL)
        _assert_abs_sum(got, np.asarray(jv), abs_sum)


def _gat_graphs(rng, n, e, chunked):
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    dst[: e // 4] = 3  # a hub row that a chunk boundary splits
    kw = dict(e_tile=64, s_tile=64)
    jg = jprepare_graph(src, dst, n, add_self_loops=True, **kw)
    tg = prepare_graph(src, dst, n, add_self_loops=True, layouts=("slot",), device="cpu",
                       max_chunk_slots=64 * 3 if chunked else 4 << 20, **kw)
    assert bool(tg.plan.chunks) == chunked
    return jg, tg


@pytest.mark.parametrize("H,D", [(4, 8), (2, 64)])
@pytest.mark.parametrize("route", ["fused", "composed"])
@pytest.mark.parametrize("chunked", [False, True])
def test_gat_routes_read_xh_in_kernel(monkeypatch, H, D, route, chunked):
    """gat_attention_spmm by both routes (fused_max_edges at its default and
    0) and mh_spmm hand `plan_segment_sum_mh` xh and the plan's edge-order
    src, one call a plan: the forward over `plan`, the xh gradient over
    `plan_t`. Forward and all three gradients against JAX's fused route,
    and mh_spmm with dx and dw against JAX's, chunked or not."""
    rng = np.random.default_rng(H * D + len(route) + chunked)
    n = 120
    jg, tg = _gat_graphs(rng, n, 900, chunked)
    xh = rng.standard_normal((n, H, D)).astype(np.float32)
    a_s = (0.3 * rng.standard_normal((n, H))).astype(np.float32)
    a_d = (0.3 * rng.standard_normal((n, H))).astype(np.float32)
    co = rng.standard_normal((n, H, D)).astype(np.float32)
    ja = [jnp.asarray(a) for a in (xh, a_s, a_d)]

    def jgat(*a):
        return japi.gat_attention_spmm(jg, *a, backend="pallas")

    jout = np.asarray(jgat(*ja))
    jgr = jax.grad(lambda *a: jnp.vdot(jgat(*a), jnp.asarray(co)), argnums=(0, 1, 2))(*ja)
    calls = _record(monkeypatch, "plan_segment_sum_mh")
    args = [torch.from_numpy(a).requires_grad_() for a in (xh, a_s, a_d)]
    out = tapi.gat_attention_spmm(tg, *args, **({} if route == "fused" else
                                                 {"fused_max_edges": 0}))
    torch.vdot(out.reshape(-1), torch.from_numpy(co).reshape(-1)).backward()
    assert calls == [True, True]
    np.testing.assert_allclose(out.detach().numpy(), jout, **TOL_GAT)
    for a, b in zip(jgr, args):
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a), **TOL_GAT_GRAD)
    w = rng.standard_normal((tg.num_edges, H)).astype(np.float32)

    def jloss(xx, ww):
        return jnp.vdot(japi.mh_spmm(jg.src, jg.dst, ww, xx, n, graph=jg, backend="pallas"),
                        jnp.asarray(co))

    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(xh), jnp.asarray(w))
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (xh, w))
    o = tapi.mh_spmm(tg.src, tg.dst, wt, xt, n, graph=tg)
    torch.vdot(o.reshape(-1), torch.from_numpy(co).reshape(-1)).backward()
    assert calls == [True] * 4
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw), **TOL)
