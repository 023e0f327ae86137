"""The port's aligned-edge-block (AEB) slot path against the JAX package:
`Graph.edge_pos_t`, the plain `plan_segment_sum_sr2` / `_packed2` against
their Pallas kernels, per-call edge weights over slot plans (`slot_dyn`:
`segment_spmm` and `gather_weight_scatter` with dx and dw, chunked and
not) and `index_scatter` over slot plans.

Inputs come from numpy with a seed and go through both packages; JAX runs
its Pallas kernels in interpret mode. Tolerances: the plain kernels are
held to 1e-4 * sum|terms| + 1e-5 per element (the Pallas f32 kernels
multiply through a bf16 hi/lo split); the SpMM paths to rtol/atol 2e-4
(the bound of tests/test_ops.py); pure scatters to 1e-5 against the JAX
reference and 2e-4 against its Pallas path.
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
from geot_tpu.ops import reference as jref
from geot_tpu_torch.graph import plan as tplan
from geot_tpu_torch.graph.structures import build_graph as tbuild_graph
from geot_tpu_torch.ops import api as tapi
from geot_tpu_torch.ops import reference as tref

TOL = dict(rtol=2e-4, atol=2e-4)
TOL_SCATTER = dict(rtol=1e-5, atol=1e-5)


def _zipf_edges(rng, n, nnz, hub_edges=0, hub=3, power=1.1):
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** -power
    p /= p.sum()
    dst = np.concatenate([rng.choice(n, size=nnz, p=p),
                          np.full(hub_edges, hub)]).astype(np.int32)
    src = rng.integers(0, n, size=len(dst), dtype=np.int32)
    return src, dst


def _graphs(feature_hint, seed=42, n=300, nnz=2000, hub_edges=0, weighted=False):
    """(JAX graph, port graph, n) with slot plans only: per-call weights
    take the slot_dyn route in both."""
    rng = np.random.default_rng(seed)
    src, dst = _zipf_edges(rng, n, nnz, hub_edges, power=1.0)
    w = rng.standard_normal(len(src)).astype(np.float32) if weighted else None
    kw = dict(e_tile=64, s_tile=64, bat_e_tile=64, bat_s_tile=32, feature_hint=feature_hint,
              layouts=("slot",))
    jg = jbuild_graph(src, dst, n, edge_weight=w, **kw)
    tg = tbuild_graph(src, dst, n, edge_weight=w, prefer_dyn="sr", device="cpu", **kw)
    return jg, tg, n


@pytest.mark.parametrize("feature_hint,hub_edges", [(64, 0), (128, 0), (64, 700)])
def test_edge_pos_t_equal(feature_hint, hub_edges):
    """Graph.edge_pos_t = perm_t[plan_t.edge_pos], EQUAL to the reference's
    (pack-aligned and not, with a hub); None without the slot layout."""
    jg, tg, _ = _graphs(feature_hint, hub_edges=hub_edges)
    assert tg.edge_pos_t.dtype == torch.int32
    np.testing.assert_array_equal(tg.edge_pos_t.numpy(), np.asarray(jg.edge_pos_t))
    np.testing.assert_array_equal(
        tg.edge_pos_t.numpy(),
        tg.perm_t.numpy()[tg.plan_t.edge_pos.numpy()])
    assert tg.plan.pack_align == (16 if feature_hint <= 64 else 1)
    src, dst = tg.src.numpy(), tg.dst.numpy()
    assert tbuild_graph(src, dst, 300, layouts=("bat",), device="cpu").edge_pos_t is None


def _kernel_plan(rng, pack_align, e_tile=64):
    n = 400
    src, dst = _zipf_edges(rng, n, 1500, 500)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    kw = dict(e_tile=e_tile, s_tile=128, pack_align=pack_align, num_src_nodes=n)
    jp = jplan.build_segment_plan(dst, src, n + 100, **kw)
    tp = tplan.build_segment_plan(dst, src, n + 100, **kw, device="cpu")
    return jp, tp, len(dst)


def _assert_abs_sum(t, j, a):
    bad = np.abs(t - j) > 1e-4 * a + 1e-5
    assert not bad.any(), (int(bad.sum()), float(np.abs(t - j).max()))


def _weights(rng, tp, nnz, kind):
    """(w_slots, w_edge) numpy for a weight kind: static slot weights (0 on
    pads), per-call edge weights, both, or neither (the plan's mask)."""
    T, E = tp.num_tiles, tp.e_tile
    ws = we = None
    if kind in ("static", "both"):
        ws = (tp.mask.numpy() * rng.standard_normal((T, E))).astype(np.float32)
    if kind in ("dynamic", "both"):
        we = rng.standard_normal(nnz).astype(np.float32)
    return ws, we


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _abs(a):
    return None if a is None else np.abs(a)


@pytest.mark.parametrize("layout,kind,pack_align", [
    ("slot", "static", 16), ("slot", "dynamic", 1), ("slot", "both", 16),
    ("edge", "static", 1), ("edge", "dynamic", 16), ("edge", "both", 1),
    ("edge", "both", 16)])
def test_plain_sr2_matches_pallas_interpret(layout, kind, pack_align):
    """plan_segment_sum_sr2_plain against the Pallas sr2 kernel in
    interpret mode, on the same plan: values in slot or edge order,
    static and/or per-call weights."""
    rng = np.random.default_rng(7 + pack_align + len(kind) + len(layout))
    jp, tp, nnz = _kernel_plan(rng, pack_align)
    T, E, F = tp.num_tiles, tp.e_tile, 128
    ws, we = _weights(rng, tp, nnz, kind)
    v = rng.standard_normal((T * E if layout == "slot" else nnz, F)).astype(np.float32)
    j = jps.plan_segment_sum_sr2(jp, jnp.asarray(v), vals_layout=layout, w_slots=_j(ws),
                                 w_edge=_j(we), interpret=True)
    t = tref.plan_segment_sum_sr2_plain(tp, torch.from_numpy(v), vals_layout=layout,
                                        w_slots=_t(ws), w_edge=_t(we)).numpy()
    a = tref.plan_segment_sum_sr2_plain(tp, torch.from_numpy(np.abs(v)), vals_layout=layout,
                                        w_slots=_t(_abs(ws)), w_edge=_t(_abs(we))).numpy()
    assert t.shape == np.asarray(j).shape
    _assert_abs_sum(t, np.asarray(j), a)


@pytest.mark.parametrize("kind", ["mask", "dynamic"])
@pytest.mark.parametrize("F", [8, 16, 32, 64])
def test_plain_packed2_matches_pallas_interpret(F, kind):
    """plan_segment_sum_packed2_plain against the Pallas packed2 kernel in
    interpret mode on a pack-aligned plan (e_tile 128: at least 8 packed
    rows per tile at every width)."""
    rng = np.random.default_rng(F + len(kind))
    jp, tp, nnz = _kernel_plan(rng, 16, e_tile=128)
    _, we = _weights(rng, tp, nnz, "dynamic" if kind == "dynamic" else "none")
    v = rng.standard_normal((nnz, F)).astype(np.float32)
    j = jps.plan_segment_sum_packed2(jp, jnp.asarray(v), w_edge=_j(we), interpret=True)
    t = tref.plan_segment_sum_packed2_plain(tp, torch.from_numpy(v), w_edge=_t(we)).numpy()
    a = tref.plan_segment_sum_packed2_plain(tp, torch.from_numpy(np.abs(v)),
                                            w_edge=_t(_abs(we))).numpy()
    _assert_abs_sum(t, np.asarray(j), a)


def test_plain_sr2_edge_rows_and_chunk_slices():
    """The plain AEB sum: a slice of edge-order values with its e_base
    sums the edges it holds, rows outside it read as zero, and per-call
    weights past their end weigh 0; the two halves add up to the whole."""
    rng = np.random.default_rng(5)
    _, tp, nnz = _kernel_plan(rng, 16)
    v = torch.from_numpy(rng.standard_normal((nnz, 24)).astype(np.float32))
    we = torch.from_numpy(rng.standard_normal(nnz).astype(np.float32))
    whole = tref.plan_segment_sum_sr2_plain(tp, v, vals_layout="edge", w_edge=we)
    sliced = tref.plan_segment_sum_sr2_plain(tp, v[64:], vals_layout="edge", w_edge=we,
                                             e_base=64)
    head = tref.plan_segment_sum_sr2_plain(tp, v[:64], vals_layout="edge", w_edge=we[:64])
    torch.testing.assert_close(sliced + head, whole, rtol=1e-5, atol=1e-5)
    assert 0 < torch.count_nonzero(head.sum(dim=1)).item() < torch.count_nonzero(
        whole.sum(dim=1)).item()


@pytest.mark.parametrize("n_feat,feature_hint", [(7, 128), (16, 64), (48, 64), (64, 64),
                                                 (128, 128)])
def test_slot_dyn_matches_jax(n_feat, feature_hint):
    """Per-call weights over slot plans (slot_dyn): gather_weight_scatter
    and segment_spmm forward, dx and dw against JAX's Pallas path and
    jax.grad, on a pack-aligned plan (feature_hint 64: edge-order gather +
    packed2 at n <= 64) and an unaligned one (slot gather + sr2)."""
    jg, tg, n = _graphs(feature_hint)
    assert tapi.dispatch_path(tg, dynamic_w=True) == "slot_dyn"
    assert japi.dispatch_path(jg, dynamic_w=True, backend="pallas") == "slot_dyn"
    assert bool(tapi._aeb_packed_ok(tg.plan, n_feat)) == bool(
        japi._aeb_packed_ok(jg.plan, n_feat))
    rng = np.random.default_rng(n_feat + feature_hint)
    x = rng.standard_normal((n, n_feat)).astype(np.float32)
    w = rng.standard_normal(tg.num_edges).astype(np.float32)
    cot = rng.standard_normal((n, n_feat)).astype(np.float32)

    def jloss(xx, ww):
        out = japi.gather_weight_scatter(jg.src, jg.dst, ww, xx, n, graph=jg, backend="pallas")
        return jnp.vdot(out, jnp.asarray(cot)), out

    (_, jout), (jdx, jdw) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = tapi.gather_weight_scatter(tg.src, tg.dst, wt, xt, n, graph=tg)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    torch.vdot(out.reshape(-1), torch.from_numpy(cot).reshape(-1)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw), **TOL)
    seg = tapi.segment_spmm(tg, torch.from_numpy(x), edge_weight=torch.from_numpy(w))
    np.testing.assert_allclose(seg.numpy(), np.asarray(jout), **TOL)
    if n_feat == 16:
        jm = japi.segment_spmm(jg, jnp.asarray(x), jnp.asarray(w), reduce="mean",
                               backend="pallas")
        tm = tapi.segment_spmm(tg, torch.from_numpy(x), edge_weight=torch.from_numpy(w),
                               reduce="mean")
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)


@pytest.mark.parametrize("n_feat,feature_hint", [(16, 64), (16, 128), (48, 128), (128, 128)])
def test_dynamic_weight_chunked_aeb(n_feat, feature_hint):
    """Mirror of tests/test_ops.py::test_dynamic_weight_chunked_aeb: per-call
    weights through the AEB kernels, chunked (a hub window split) and not,
    against the reference, with dx and dw."""
    rng = np.random.default_rng(77)
    n = 200
    dst = np.concatenate([np.full(700, 5, np.int32), rng.integers(0, n, 900).astype(np.int32)])
    src = rng.integers(0, n, len(dst)).astype(np.int32)
    tg = tbuild_graph(src, dst, n, e_tile=64, s_tile=64, feature_hint=feature_hint,
                      layouts=("slot",), prefer_dyn="sr", device="cpu")
    ch = tplan.compute_chunks(tg.plan.out_block.numpy(), 5)
    assert len(ch) > 2 and any(b[2] < a[3] for a, b in zip(ch[:-1], ch[1:]))
    tc = dataclasses.replace(tg, plan=dataclasses.replace(tg.plan, chunks=ch))
    w = rng.standard_normal(len(dst)).astype(np.float32)
    x = rng.standard_normal((n, n_feat)).astype(np.float32)
    cot = rng.standard_normal((n, n_feat)).astype(np.float32)
    js, jd = jnp.asarray(tg.src.numpy()), jnp.asarray(tg.dst.numpy())

    def jloss(xx, ww):
        return jnp.vdot(jref.gather_weight_scatter_ref(js, jd, ww, xx, n), jnp.asarray(cot))

    expect = jref.gather_weight_scatter_ref(js, jd, jnp.asarray(w), jnp.asarray(x), n)
    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    for g in (tg, tc):
        xt = torch.from_numpy(x).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        out = tapi.gather_weight_scatter(g.src, g.dst, wt, xt, n, graph=g)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(expect), **TOL)
        torch.vdot(out.reshape(-1), torch.from_numpy(cot).reshape(-1)).backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), **TOL)
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw), **TOL)


def _iscat_pair(idx, n_seg, **kw):
    return (jplan.build_segment_plan(idx, None, n_seg, **kw),
            tplan.build_segment_plan(idx, None, n_seg, **kw, device="cpu"))


@pytest.mark.parametrize("n_feat,reduce", [(4, "sum"), (32, "mean"), (100, "sum")])
def test_index_scatter_aeb_uniform_chunks(n_feat, reduce):
    """Mirror of tests/test_ops.py::test_index_scatter_aeb_uniform_chunks:
    index_scatter over a slot plan with uniformized chunks (pad tiles),
    forward against JAX's Pallas path and reference, and
    the gradient g[index]."""
    rng = np.random.default_rng(78)
    nnz, n_seg = 3000, 400
    idx = np.sort(rng.integers(0, n_seg, nnz)).astype(np.int32)
    vals = rng.standard_normal((nnz, n_feat)).astype(np.float32)
    cot = rng.standard_normal((n_seg, n_feat)).astype(np.float32)
    jp, tp = _iscat_pair(idx, n_seg, e_tile=64, s_tile=64, max_chunk_slots=512)
    assert tp.chunks and tp.chunk_blocks > 0
    jpal = japi.index_scatter(jnp.asarray(vals), jnp.asarray(idx), n_seg, reduce=reduce,
                              plan=jp, backend="pallas")
    jr = japi.index_scatter(jnp.asarray(vals), jnp.asarray(idx), n_seg, reduce=reduce,
                            backend="reference")
    tv = torch.from_numpy(vals).requires_grad_()
    t = tapi.index_scatter(tv, torch.from_numpy(idx), n_seg, reduce=reduce, plan=tp)
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(jpal), **TOL)
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(jr), **TOL_SCATTER)
    torch.vdot(t.reshape(-1), torch.from_numpy(cot).reshape(-1)).backward()
    jgrad = jax.grad(lambda v: jnp.vdot(japi.index_scatter(
        v, jnp.asarray(idx), n_seg, reduce=reduce, backend="reference"),
        jnp.asarray(cot)))(jnp.asarray(vals))
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jgrad), **TOL_SCATTER)


def test_index_scatter_aeb_nondivisible_nnz():
    """Mirror of tests/test_ops.py::test_index_scatter_aeb_nondivisible_nnz:
    nnz not a multiple of e_tile (the reference pads its ragged tail; the
    port reads only real edges)."""
    rng = np.random.default_rng(79)
    nnz, n_seg = 777, 100
    idx = np.sort(rng.integers(0, n_seg, nnz)).astype(np.int32)
    vals = rng.standard_normal((nnz, 24)).astype(np.float32)
    jp, tp = _iscat_pair(idx, n_seg, e_tile=128, s_tile=128)
    j = japi.index_scatter(jnp.asarray(vals), jnp.asarray(idx), n_seg, plan=jp,
                           backend="pallas")
    jr = japi.index_scatter(jnp.asarray(vals), jnp.asarray(idx), n_seg, backend="reference")
    t = tapi.index_scatter(torch.from_numpy(vals), torch.from_numpy(idx), n_seg, plan=tp)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(jr), **TOL_SCATTER)
