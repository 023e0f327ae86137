"""The bucketed BAT route against the JAX package.

- `build_bucketed_bat_plan`'s host arrays equal the reference's at the
  case of tests/test_ops.py's bucketed test (700 nodes, e_tile 64,
  bucket_rows 160, max_chunk_tiles 6: several buckets and chunks), in both
  directions, weighted and not, built alone and by `build_graph`.
- The plan's edge-row schedule against a brute-force entry list (every
  live padded entry once, each row's in bucket order; the -1 pads, the
  sentinel block and the pad windows past n_blocks add nothing), and a
  numpy walk in the kernel's order against the float64 sum.
- `segment_spmm` over the bucketed route, forward and dx, against JAX's
  bucketed route (Pallas in interpret mode, the reference's chunk order)
  at tests/test_ops.py's tolerance for it, 2e-3, and against JAX's f32
  reference path at 2e-4; GCN over a bucketed graph against the flax
  model.
- `dispatch_path` against the reference's over weighted, unweighted and
  per-call weights, with and without hybrid plans, bucketed plans and
  slot plans, at `feature_hint` 64 and 128.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geot_tpu.graph.datasets import synthetic_clustered_graph
from geot_tpu.graph.plan import build_bucketed_bat_plan as jbucketed
from geot_tpu.graph.structures import build_graph as jbuild_graph
from geot_tpu.models import GCN as JGCN
from geot_tpu.ops import api as japi
from geot_tpu.ops import reference as jref
from geot_tpu_torch.graph import plan as tplan
from geot_tpu_torch.graph.structures import build_graph as tbuild_graph
from geot_tpu_torch.models import GCN, params_from_flax
from geot_tpu_torch.ops import api as tapi
from geot_tpu_torch.ops.bat_kernels import bucketed_sum, bucketed_sum_plain
from test_torch_rowsum import SMALL, _check_schedule, _walk

KW = dict(e_tile=64, s_tile=64, bucket_rows=160, max_chunk_tiles=6)
TOL_PALLAS = dict(rtol=2e-3, atol=2e-3)
TOL_F32 = dict(rtol=2e-4, atol=2e-4)
ARRAYS = ("out_block", "vblock", "dst3", "src_local", "w_pad")
META = ("e_tile", "s_tile", "num_segments", "n_blocks", "num_edges", "n_vblocks",
        "bucket_rows", "chunks", "chunk_blocks")


def _case(seed=23, n=700, nnz=5000):
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, n, nnz)).astype(np.int32)
    src = rng.integers(0, n, nnz).astype(np.int32)
    w = rng.standard_normal(nnz).astype(np.float32)
    return rng, n, src, dst, w


def _directions(src, dst, w):
    """(gather, reduce, weights) of the forward and the transpose plan."""
    perm_t = np.argsort(src, kind="stable")
    return {"forward": (src, dst, w),
            "transpose": (dst[perm_t], src[perm_t], None if w is None else w[perm_t])}


def _equal(jp, tp):
    for k in ARRAYS:
        a = getattr(jp, k)
        b = getattr(tp, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=k)
    for k in META:
        assert getattr(jp, k) == getattr(tp, k), k


@pytest.mark.parametrize("direction", ["forward", "transpose"])
@pytest.mark.parametrize("weighted", [False, True])
def test_bucketed_plan_arrays_equal_jax(direction, weighted):
    _, n, src, dst, w = _case()
    gi, ri, wd = _directions(src, dst, w if weighted else None)[direction]
    jp = jbucketed(gi, ri, n, n, edge_weight=wd, **KW)
    tp = tplan.build_bucketed_bat_plan(gi, ri, n, n, edge_weight=wd, device="cpu", **KW)
    _equal(jp, tp)
    assert len(tp.chunks) > 6 and len({c[4] for c in tp.chunks}) == 5  # buckets of 160 rows
    # the global source ids: the bucket's rows plus the local id, the
    # original gather index on every live entry
    live = tp.dst3.reshape(-1).numpy() >= 0
    assert live.sum() == len(gi)
    srcg, loc = tp.src.numpy(), tp.src_local.numpy()
    np.testing.assert_array_equal(srcg[live] % 160, loc[live])
    np.testing.assert_array_equal(np.sort(srcg[live]), np.sort(gi))


def test_build_graph_bucketed_plans_equal_jax():
    """build_graph(bucket_table_bytes=1) builds both directions as the
    reference's gate does (its GEOT_BUCKET_TABLE_BYTES=1), on the same
    tiles and chunk cap; the row schedules' stats name them."""
    _, n, src, dst, w = _case()
    row_b, cap = 128 * 4, 6
    tg = tbuild_graph(src, dst, n, edge_weight=w, assume_sorted=True, layouts=("bat",),
                      bat_e_tile=64, bat_s_tile=64, max_chunk_bytes=cap * row_b * 64,
                      bucket_table_bytes=1, bucket_rows=160, device="cpu")
    for name, (gi, ri, wd) in zip(("bat_b", "bat_b_t"), _directions(src, dst, w).values()):
        _equal(jbucketed(gi, ri, n, n, edge_weight=wd, **KW), getattr(tg, name))
        stats = tg.build_stats["row_schedule"][name]
        assert stats["bytes"] > 0 and stats["seconds"] >= 0
    assert "bucketed_plans" in tg.build_stats["seconds"]


@pytest.mark.parametrize("feature_hint,knob,built", [
    (128, None, False), (128, 1, True), (128, 700 * 128 * 4, False), (64, 1, False)])
def test_build_graph_bucketed_gate(feature_hint, knob, built):
    """Built only past 64 features, where num_nodes * feature_hint * 4
    bytes exceed the knob (None: never)."""
    _, n, src, dst, w = _case(nnz=800)
    tg = tbuild_graph(src, dst, n, edge_weight=w, assume_sorted=True, layouts=("bat",),
                      bat_e_tile=64, bat_s_tile=64, feature_hint=feature_hint,
                      bucket_table_bytes=knob, device="cpu")
    assert (tg.bat_b is not None) == (tg.bat_b_t is not None) == built


@pytest.mark.parametrize("knobs", [{}, SMALL])
@pytest.mark.parametrize("direction", ["forward", "transpose"])
def test_bucketed_row_schedule_vs_brute_force(knobs, direction):
    _, n, src, dst, w = _case()
    # a hub row, so that at small knobs it is cut through fix-up levels
    dst = np.sort(np.concatenate([dst, np.full(300, 11, np.int32)]))
    src = np.concatenate([src, np.random.default_rng(1).integers(0, n, 300).astype(np.int32)])
    gi, ri, _ = _directions(src, dst, None)[direction]
    bp = tplan.build_bucketed_bat_plan(gi, ri, n, n, device="cpu", **KW)
    if knobs:
        bp = tplan.with_row_schedule(bp, **knobs)
    d = bp.dst3.reshape(-1).numpy().astype(np.int64)
    edge = np.flatnonzero(d >= 0)
    _check_schedule(bp.row_sched, d[edge], edge, bp.n_blocks * bp.s_tile, **knobs)
    assert int(bp.vblock.max()) == bp.n_vblocks  # pad tiles read the sentinel
    assert int(bp.out_block.max()) >= bp.n_blocks - 1


@pytest.mark.parametrize("knobs", [{}, SMALL])
@pytest.mark.parametrize("weighted", [False, True])
def test_walk_bucketed_vs_plain_and_float64(knobs, weighted):
    """The kernel's order (each row's entries in bucket order, slices, the
    fix-up tree) against the float64 sum at 2e-5, and the plain version
    (the reference's chunk order) against it too."""
    rng, n, src, dst, w = _case()
    bp = tplan.build_bucketed_bat_plan(src, dst, n, n, edge_weight=w if weighted else None,
                                       device="cpu", **KW)
    if knobs:
        bp = tplan.with_row_schedule(bp, **knobs)
    x = rng.standard_normal((n, 40)).astype(np.float32)
    walk = _walk(bp.row_sched, x, src=bp.src.numpy(),
                 w_edge=None if bp.w_pad is None else bp.w_pad.numpy())[:n]
    exact = np.zeros((n, 40))
    np.add.at(exact, dst, (w[:, None] if weighted else 1.0) * x[src].astype(np.float64))
    np.testing.assert_allclose(walk, exact, rtol=2e-5, atol=2e-5)
    plain = bucketed_sum_plain(bp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(plain, exact, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(bucketed_sum(bp, torch.from_numpy(x)).numpy(), plain)


def _graph_pair(n, src, dst, w):
    """(JAX graph with the small-bucket plans swapped in, as
    tests/test_ops.py does; the port's graph built with the same knobs)."""
    jg = jbuild_graph(src, dst, n, edge_weight=w, assume_sorted=True, layouts=("bat",),
                      e_tile=64, s_tile=64, bat_e_tile=64, bat_s_tile=64)
    dirs = _directions(src, dst, w)
    jg = dataclasses.replace(
        jg, bat_b=jbucketed(*dirs["forward"][:2], n, n, edge_weight=dirs["forward"][2], **KW),
        bat_b_t=jbucketed(*dirs["transpose"][:2], n, n, edge_weight=dirs["transpose"][2], **KW))
    tg = tbuild_graph(src, dst, n, edge_weight=w, assume_sorted=True, layouts=("bat",),
                      bat_e_tile=64, bat_s_tile=64, max_chunk_bytes=6 * 128 * 4 * 64,
                      bucket_table_bytes=1, bucket_rows=160, device="cpu")
    _equal(jg.bat_b, tg.bat_b)
    _equal(jg.bat_b_t, tg.bat_b_t)
    return jg, tg


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("F", [96, 7])
def test_segment_spmm_bucketed_vs_jax(weighted, F):
    rng, n, src, dst, w = _case()
    w = w if weighted else None
    jg, tg = _graph_pair(n, src, dst, w)
    assert tapi.dispatch_path(tg) == japi.dispatch_path(jg, backend="pallas") == "bucketed"
    x = rng.standard_normal((n, F)).astype(np.float32)
    cot = rng.standard_normal((n, F)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    out = tapi.segment_spmm(tg, xt)
    (out * torch.from_numpy(cot)).sum().backward()
    jx = jnp.asarray(x)
    jw = None if w is None else jnp.asarray(w)

    def ref_fn(xx):
        if jw is None:
            return jref.gather_scatter_ref(jnp.asarray(src), jnp.asarray(dst), xx, n)
        return jref.gather_weight_scatter_ref(jnp.asarray(src), jnp.asarray(dst), jw, xx, n)

    for fn, tol in ((lambda xx: japi.segment_spmm(jg, xx, backend="pallas"), TOL_PALLAS),
                    (ref_fn, TOL_F32)):
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(fn(jx)), **tol)
        gx = jax.grad(lambda xx: jnp.vdot(fn(xx), cot))(jx)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **tol)


def test_gcn_over_bucketed_graph_vs_flax():
    """GCN(conv_kwargs={"normalize": False}) over a bucketed graph with the
    norm baked in: every layer's SpMM takes the bucketed route, against
    the flax GCN over the JAX graph on its reference path (f32)."""
    rng, n, src, dst, w = _case(seed=5, nnz=3000)
    w = np.abs(w) / 8
    jg, tg = _graph_pair(n, src, dst, w)
    x = rng.standard_normal((n, 24)).astype(np.float32)
    jm = JGCN(hidden_features=32, num_layers=3, out_features=7, backend="reference",
              conv_kwargs={"normalize": False})
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jg)
    j = jm.apply(params, jnp.asarray(x), jg)
    tm = GCN(24, 32, 3, 7, conv_kwargs={"normalize": False}, device="cpu").eval()
    tm.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    with torch.inference_mode():
        t = tm(torch.from_numpy(x), tg)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL_F32)


def _audit_graphs(layouts, weighted, feature_hint, monkeypatch):
    tiles = dict(e_tile=64, s_tile=32, bat_e_tile=64, bat_s_tile=32, feature_hint=feature_hint)
    d = synthetic_clustered_graph(1024, 24_000, mixing=0.1, mean_community=256, seed=0)
    order = np.argsort(d.dst, kind="stable")
    src, dst = d.src[order], d.dst[order]
    w = (np.random.default_rng(0).random(len(src)).astype(np.float32) + 0.1
         if weighted else None)
    monkeypatch.setenv("GEOT_BUCKET_TABLE_BYTES", "1")
    jg = jbuild_graph(src, dst, 1024, edge_weight=w, assume_sorted=True, layouts=layouts,
                      **tiles)
    tg = tbuild_graph(src, dst, 1024, edge_weight=w, assume_sorted=True, layouts=layouts,
                      bucket_table_bytes=1, device="cpu", **tiles)
    return jg, tg


@pytest.mark.parametrize("feature_hint", [64, 128])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("layouts", [("bat",), ("bat", "slot"), ("bat", "stream")])
def test_dispatch_audit_vs_jax(layouts, weighted, feature_hint, monkeypatch):
    """dispatch_path equal to the reference's on every call kind (graph
    weights or none, per-call weights; sum, mean, max; the reference
    backend), on the graph as built and with its hybrid plans, its
    bucketed plans or both taken out."""
    jg, tg = _audit_graphs(layouts, weighted, feature_hint, monkeypatch)
    assert (jg.bat_b is not None) == (tg.bat_b is not None) == (feature_hint == 128)
    assert (jg.hyb is not None) == (tg.hyb is not None)
    assert (tg.hyb is not None) == ("stream" in layouts and feature_hint == 128)
    seen = set()
    for drop in ((), ("hyb", "hyb_t"), ("bat_b", "bat_b_t"), ("bat_b", "bat_b_t", "hyb", "hyb_t")):
        none = {k: None for k in drop}
        jv, tv = dataclasses.replace(jg, **none), dataclasses.replace(tg, **none)
        for dyn in (False, True):
            for reduce in ("sum", "mean", "max"):
                jp = japi.dispatch_path(jv, dynamic_w=dyn, reduce=reduce, backend="pallas")
                assert tapi.dispatch_path(tv, dynamic_w=dyn, reduce=reduce) == jp, (
                    drop, dyn, reduce)
                seen.add(jp)
        assert tapi.dispatch_path(tv, backend="reference") == "xla"
    assert "xla" in seen and ("bucketed" in seen) == (feature_hint == 128)
