"""The port's narrow-feature BAT path against the JAX package: packed
plans (k-major `dst_km`), the plain packed sum, and the fused ops that take
the packed branch.

Same inputs (numpy, from a seed) go through both. The JAX side runs its
Pallas kernels in interpret mode (`backend="pallas"`, or `interpret=True`
for the kernel called directly), whose one-hot products use a hi/lo bf16
split (~2^-16 relative): rtol/atol 2e-4 against them. Against the JAX f32
XLA reference: 1e-4, the reference's own bound where chunks split a hub
window and regroup a 1500-term f32 sum (`test_ops.py:362`, ROADMAP C.4),
and 1e-5 for the pure scatter of `index_scatter` on a whole plan.
Plan arrays and meta must be EQUAL: the CUDA kernel and the Pallas kernel
walk the same tiles.
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
from geot_tpu.ops import reference as jref
from geot_tpu.ops.pallas_segment import bat_segment_sum_packed as jbat_packed
from geot_tpu_torch.graph import plan as tplan
from geot_tpu_torch.graph.structures import build_graph as tbuild_graph
from geot_tpu_torch.ops import api as tapi
from geot_tpu_torch.ops import reference as tref
from geot_tpu_torch.ops.bat_kernels import bat_segment_sum_packed

TOL_PALLAS = dict(rtol=2e-4, atol=2e-4)
TOL_REF = dict(rtol=1e-4, atol=1e-4)
TOL_SCATTER = dict(rtol=1e-5, atol=1e-5)
META_KEYS = ("e_tile", "s_tile", "num_segments", "n_blocks", "num_edges",
             "n_vblocks", "km_pack", "chunks", "chunk_blocks", "chunk_vblocks")
PACKS = (2, 4, 8, 16)


def _hubby(rng, n, nnz, hub_edges, hub=7):
    dst = np.concatenate([np.full(hub_edges, hub, np.int32),
                          rng.integers(0, n, nnz).astype(np.int32)])
    src = rng.integers(0, n, len(dst)).astype(np.int32)
    return src, dst


def _assert_plan_equal(ja, jm, ta, tm):
    assert sorted(ja) == sorted(ta)
    for k in ja:
        np.testing.assert_array_equal(np.asarray(ja[k]), np.asarray(ta[k]), err_msg=k)
        assert np.asarray(ja[k]).dtype == np.asarray(ta[k]).dtype, k
    for k in META_KEYS:
        assert jm[k] == tm[k], (k, jm[k], tm[k])


@pytest.mark.parametrize("km_pack", PACKS)
@pytest.mark.parametrize("chunking", ["whole", "chunked", "with_chunks"])
def test_packed_plan_host_equal(km_pack, chunking):
    """build_bat_plan_host with km_pack: out_block, vblock, dst3 and dst_km
    equal to the JAX package's, whole and chunked (uniformized chunks, a
    split hub window); `with_chunks` keeps dst_km as it is."""
    rng = np.random.default_rng(km_pack + len(chunking))
    n = 300
    _, dst = _hubby(rng, n, 2000, 900, hub=3)
    dst = np.sort(dst)
    mct = 8 if chunking == "chunked" else 8192
    kw = dict(e_tile=64, s_tile=32, km_pack=km_pack, max_chunk_tiles=mct)
    ja, jm = jplan.build_bat_plan_host(dst, n, **kw)
    ta, tm = tplan.build_bat_plan_host(dst, n, **kw)
    _assert_plan_equal(ja, jm, ta, tm)
    assert tm["km_pack"] == km_pack and ta["dst_km"].shape == (tm["n_vblocks"] + 1, 1, 64)
    assert (ta["dst_km"][-1] == -1).all()  # the sentinel block
    assert bool(tm["chunks"]) == (chunking == "chunked")
    if chunking == "chunked":
        assert tm["chunk_blocks"] > 0
        assert any(b[2] < a[3] for a, b in zip(tm["chunks"][:-1], tm["chunks"][1:]))
    tbp = tplan.bat_plan_from_host(ta, tm)
    np.testing.assert_array_equal(tbp.dst_km.numpy(), np.asarray(
        jplan.bat_plan_from_host(ja, jm).dst_km))
    if chunking == "with_chunks":
        ch = tplan.compute_chunks(ta["out_block"], 8)
        tc = tplan.with_chunks(tbp, ch)
        assert tc.chunks == ch and torch.equal(tc.dst_km, tbp.dst_km)


@pytest.mark.parametrize("feature_hint", [7, 16, 32, 64])
@pytest.mark.parametrize("weighted", [False, True])
def test_build_graph_packed_equal(feature_hint, weighted):
    """build_graph with a narrow feature_hint builds packed bat and bat_t
    (km_pack 128 // packed_width) equal to the JAX package's."""
    rng = np.random.default_rng(feature_hint + weighted)
    n = 400
    src, dst = _hubby(rng, n, 3000, 500)
    w = rng.standard_normal(len(src)).astype(np.float32) if weighted else None
    kw = dict(e_tile=64, s_tile=32, bat_e_tile=64, bat_s_tile=32, feature_hint=feature_hint)
    jg = jbuild_graph(src, dst, n, edge_weight=w, layouts=("bat",), **kw)
    tg = tbuild_graph(src, dst, n, edge_weight=w, layouts=("bat",), device="cpu", **kw)
    pack = 128 // tplan.packed_width(feature_hint)
    for name in ("bat", "bat_t"):
        jb, tb = getattr(jg, name), getattr(tg, name)
        assert tb.km_pack == jb.km_pack == pack
        for k in ("out_block", "vblock", "dst3", "dst_km"):
            np.testing.assert_array_equal(np.asarray(getattr(jb, k)), getattr(tb, k).numpy(),
                                          err_msg=f"{name}.{k}")
        for k in META_KEYS:
            assert getattr(jb, k) == getattr(tb, k), (name, k)


@pytest.mark.parametrize("km_pack", PACKS)
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_packed_plain_vs_pallas(km_pack, weighted, ragged):
    """bat_segment_sum_packed (plain on the CPU) against the JAX
    bat_segment_sum_packed in interpret mode; `ragged`: exactly nnz value
    rows (the last block partial, the reference's tail path)."""
    rng = np.random.default_rng(3 * km_pack + 2 * weighted + ragged)
    n, e_tile, s_tile = 150, 64, 32
    _, dst = _hubby(rng, n, 700, 200)
    dst = np.sort(dst)
    nnz = len(dst)
    arrays, meta = jplan.build_bat_plan_host(dst, n, e_tile=e_tile, s_tile=s_tile,
                                             km_pack=km_pack)
    jbp = jplan.bat_plan_from_host(arrays, meta)
    tbp = tplan.bat_plan_from_host(arrays, meta)
    F = 128 // km_pack
    rows = nnz if ragged else meta["n_vblocks"] * e_tile
    assert (rows % e_tile != 0) == ragged
    vals = rng.standard_normal((rows, F)).astype(np.float32)
    w = rng.standard_normal(nnz).astype(np.float32) if weighted else None
    j = jbat_packed(jbp, jnp.asarray(vals), None if w is None else jnp.asarray(w),
                    interpret=True)
    t = bat_segment_sum_packed(tbp, torch.from_numpy(vals),
                               None if w is None else torch.from_numpy(w))
    assert t.shape == tuple(j.shape) == (meta["n_blocks"] * s_tile, F)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL_PALLAS)
    assert torch.equal(t, tref.bat_segment_sum_packed_plain(
        tbp, torch.from_numpy(vals), None if w is None else torch.from_numpy(w)))
    # and against the f32 oracle on the real rows
    wt = torch.ones(nnz) if w is None else torch.from_numpy(w)
    exp = tref.gather_weight_scatter_ref(torch.arange(nnz), torch.from_numpy(dst), wt,
                                         torch.from_numpy(vals[:nnz]), meta["n_blocks"] * s_tile)
    np.testing.assert_allclose(t.numpy(), exp.numpy(), **TOL_SCATTER)


def test_packed_wrapper_rules():
    rng = np.random.default_rng(1)
    dst = np.sort(rng.integers(0, 50, 300)).astype(np.int32)
    bp = tplan.build_bat_plan(dst, 50, e_tile=32, s_tile=16, km_pack=4, device="cpu")
    vals = torch.zeros(300, 32)
    assert bat_segment_sum_packed(bp, vals).shape == (bp.n_blocks * 16, 32)
    for bad in (torch.zeros(300, 16), torch.zeros(300, 7)):
        with pytest.raises(ValueError, match="km_pack"):
            bat_segment_sum_packed(bp, bad)
    with pytest.raises(ValueError, match="km_pack"):
        bat_segment_sum_packed(dataclasses.replace(bp, dst_km=None), vals)
    # a wide plan, or a width the plan is not packed for: the fused ops run
    # the wide sum at the rows' own width (packed width 0)
    wide = tplan.build_bat_plan(dst, 50, e_tile=32, s_tile=16, device="cpu")
    assert tapi._bat_packed(wide, 32) == 0 and tapi._bat_packed(bp, 32) == 32
    assert tapi._bat_packed(bp, 20) == 32 and tapi._bat_packed(bp, 40) == 0
    assert tapi._bat_packed(bp, 100) == 0


def _graphs(n, src, dst, w, feature_hint, chunked):
    """(JAX graph, port graph) over the same edges, tiles and packing; with
    `chunked`, 4 tiles of 64 edges per chunk so the hub window (600 edges,
    10 tiles) splits."""
    kw = dict(e_tile=64, s_tile=64, bat_e_tile=64, bat_s_tile=64, feature_hint=feature_hint)
    budget = 4 * 64 * feature_hint * 4 if chunked else 1 << 30
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOT_MAX_CHUNK_BYTES", str(budget))
        jg = jbuild_graph(src, dst, n, edge_weight=w, layouts=("bat",), **kw)
    tg = tbuild_graph(src, dst, n, edge_weight=w, max_chunk_bytes=budget, layouts=("bat",),
                      device="cpu", **kw)
    assert jg.bat.chunks == tg.bat.chunks and tg.bat.km_pack > 1
    if chunked:
        ch = tg.bat.chunks
        assert len(ch) > 2 and any(b[2] < a[3] for a, b in zip(ch[:-1], ch[1:]))
    return jg, tg


@pytest.mark.parametrize("n_feat", [7, 16, 40])
@pytest.mark.parametrize("mode", ["unweighted", "static", "dynamic"])
@pytest.mark.parametrize("chunked", [False, True])
def test_packed_segment_spmm_and_grads_vs_jax(n_feat, mode, chunked):
    """segment_spmm on the bat, bat_static and bat_dyn routes of a packed
    graph (n_feat 7 and 40 padded to the packed width 8 and 64), and its dx
    and dw (through gather_weight_scatter for per-call weights), against
    the JAX package with Pallas in interpret mode and its f32 reference."""
    rng = np.random.default_rng(n_feat + len(mode) + 11 * chunked)
    n = 160
    src, dst = _hubby(rng, n, 400, 600, hub=3)
    w_static = rng.standard_normal(len(dst)).astype(np.float32)
    jg, tg = _graphs(n, src, dst, w_static if mode == "static" else None, n_feat, chunked)
    x = rng.standard_normal((n, n_feat)).astype(np.float32)
    w = rng.standard_normal(len(dst)).astype(np.float32)[np.argsort(dst, kind="stable")]
    cot = rng.standard_normal((n, n_feat)).astype(np.float32)
    dyn = mode == "dynamic"
    path = tapi.dispatch_path(tg, dynamic_w=dyn)
    assert path == {"unweighted": "bat", "static": "bat_static", "dynamic": "bat_dyn"}[mode]
    assert path == japi.dispatch_path(jg, dynamic_w=dyn, backend="pallas")

    def jop(xx, ww, backend):
        if dyn:
            return japi.gather_weight_scatter(jg.src, jg.dst, ww, xx, n, graph=jg,
                                              backend=backend)
        return japi.segment_spmm(jg, xx, backend=backend)

    def jrun(backend):
        f = lambda xx, ww: jnp.vdot(jop(xx, ww, backend), jnp.asarray(cot))  # noqa: E731
        out = jop(jnp.asarray(x), jnp.asarray(w), backend)
        return out, jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))

    jo_p, (jdx_p, jdw_p) = jrun("pallas")
    jo_r, (jdx_r, jdw_r) = jrun("reference")
    tol_ref = TOL_REF if chunked else dict(rtol=1e-5, atol=1e-5)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_(dyn)
    if dyn:
        out = tapi.gather_weight_scatter(tg.src, tg.dst, tw, tx, n, graph=tg)
        np.testing.assert_allclose(tapi.segment_spmm(tg, torch.from_numpy(x),
                                                     edge_weight=torch.from_numpy(w)).numpy(),
                                   out.detach().numpy(), rtol=0, atol=0)
    else:
        out = tapi.segment_spmm(tg, tx)
    assert out.shape == (n, n_feat)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo_p), **TOL_PALLAS)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo_r), **tol_ref)
    torch.vdot(out.reshape(-1), torch.from_numpy(cot).reshape(-1)).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx_p), **TOL_PALLAS)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx_r), **TOL_REF)
    if dyn:
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw_p), **TOL_PALLAS)
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw_r), **TOL_REF)


@pytest.mark.parametrize("n_feat", [8, 30])
def test_packed_gather_scatter_vs_jax(n_feat):
    """gather_scatter over a packed graph (the unweighted route), forward
    and x gradient, against the JAX package."""
    rng = np.random.default_rng(50 + n_feat)
    n = 120
    src, dst = _hubby(rng, n, 600, 300)
    jg, tg = _graphs(n, src, dst, None, n_feat, False)
    x = rng.standard_normal((n, n_feat)).astype(np.float32)
    cot = rng.standard_normal((n, n_feat)).astype(np.float32)
    jf = lambda xx: jnp.vdot(japi.gather_scatter(  # noqa: E731
        jg.src, jg.dst, xx, n, graph=jg, backend="pallas"), jnp.asarray(cot))
    jo = japi.gather_scatter(jg.src, jg.dst, jnp.asarray(x), n, graph=jg, backend="pallas")
    jdx = jax.grad(jf)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out = tapi.gather_scatter(tg.src, tg.dst, tx, n, graph=tg)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo), **TOL_PALLAS)
    torch.vdot(out.reshape(-1), torch.from_numpy(cot).reshape(-1)).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **TOL_PALLAS)


@pytest.mark.parametrize("n_feat", [5, 16, 64])
@pytest.mark.parametrize("chunked", [False, True])
def test_packed_index_scatter_vs_jax(n_feat, chunked):
    """index_scatter over a packed BatPlan (mirror of
    test_bat_index_scatter_chunked at its narrow width), forward and
    gradient, whole and uniformized chunked."""
    rng = np.random.default_rng(92 + n_feat + chunked)
    nnz, n_seg = 1203, 400
    idx = np.sort(rng.integers(0, n_seg, nnz)).astype(np.int32)
    vals = rng.standard_normal((nnz, n_feat)).astype(np.float32)
    cot = rng.standard_normal((n_seg, n_feat)).astype(np.float32)
    pack = 128 // tplan.packed_width(n_feat)
    kw = dict(e_tile=64, s_tile=64, km_pack=pack, max_chunk_tiles=7 if chunked else 8192)
    arrays, meta = jplan.build_bat_plan_host(idx, n_seg, **kw)
    assert bool(meta["chunks"]) == chunked
    jbp = jplan.bat_plan_from_host(arrays, meta)
    tbp = tplan.bat_plan_from_host(arrays, meta)

    def jf(v, backend):
        return japi.index_scatter(v, jnp.asarray(idx), n_seg, plan=jbp, backend=backend)

    jp = jf(jnp.asarray(vals), "pallas")
    jr = jf(jnp.asarray(vals), "reference")
    jg = jax.grad(lambda v: jnp.vdot(jf(v, "pallas"), jnp.asarray(cot)))(jnp.asarray(vals))
    tv = torch.from_numpy(vals).requires_grad_()
    t = tapi.index_scatter(tv, torch.from_numpy(idx), n_seg, plan=tbp)
    assert t.shape == (n_seg, n_feat)
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp), **TOL_PALLAS)
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(jr), **TOL_SCATTER)
    torch.vdot(t.reshape(-1), torch.from_numpy(cot).reshape(-1)).backward()
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jg), **TOL_SCATTER)
