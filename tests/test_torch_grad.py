"""The port's gradients and SDDMM against the JAX package.

Same inputs (numpy, from a seed) go through both. The JAX side runs its
Pallas kernels in interpret mode (`backend="pallas"`, or `interpret=True`
for a kernel called directly), or its f32 XLA reference
(`geot_tpu.ops.reference` under `jax.grad`). Tolerances, as in
`tests/test_ops.py`:
- SDDMM against Pallas or the reference: 1e-4
  (`test_sddmm_bat_kernel_matches_reference`);
- the BAT SpMM and its gradients against Pallas: 2e-3, and 3e-3 absolute
  on dw (`test_bat_spmm_static_dynamic_grad`, whose one-hot products use a
  hi/lo bf16 split);
- against the f32 reference: 1e-4, the reference's own bound where chunks
  split a hub window and regroup a 1500-term f32 sum (`test_ops.py:362`).
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
from geot_tpu.ops.pallas_segment import sddmm_bat as jsddmm_bat
from geot_tpu_torch.graph import plan as tplan
from geot_tpu_torch.graph.structures import build_graph as tbuild_graph
from geot_tpu_torch.ops import api as tapi
from geot_tpu_torch.ops import reference as tref
from geot_tpu_torch.ops.sddmm_kernels import sddmm_bat, sddmm_bat_plain

TOL_SDDMM = dict(rtol=1e-4, atol=1e-4)
TOL_PALLAS = dict(rtol=2e-3, atol=2e-3)
TOL_PALLAS_DW = dict(rtol=2e-3, atol=3e-3)
TOL_REF = dict(rtol=1e-4, atol=1e-4)
TILE = 64


def _hubby(rng, n, nnz, hub_edges, hub=7):
    dst = np.concatenate([np.full(hub_edges, hub, np.int32),
                          rng.integers(0, n, nnz).astype(np.int32)])
    src = rng.integers(0, n, len(dst)).astype(np.int32)
    return src, dst


def _graphs(n, src, dst, w, chunked, monkeypatch):
    """(JAX graph, port graph) over the same edges and explicit tiles; with
    `chunked`, 4 tiles of 64 edges per chunk at F 128, so the ~24-tile hub
    window is split across chunks."""
    budget = 4 * TILE * 128 * 4 if chunked else 1 << 30
    monkeypatch.setenv("GEOT_MAX_CHUNK_BYTES", str(budget))
    kw = dict(e_tile=TILE, s_tile=TILE, bat_e_tile=TILE, bat_s_tile=TILE, feature_hint=128)
    jg = jbuild_graph(src, dst, n, edge_weight=w, layouts=("bat",), **kw)
    tg = tbuild_graph(src, dst, n, edge_weight=w, max_chunk_bytes=budget, layouts=("bat",),
                      device="cpu", **kw)
    assert jg.bat.chunks == tg.bat.chunks and jg.bat_t.chunks == tg.bat_t.chunks
    if chunked:
        ch = tg.bat.chunks
        assert any(b[2] < a[3] for a, b in zip(ch[:-1], ch[1:])), "no split hub window"
    return jg, tg


def _chunked_host_plan(dst, n):
    """Host arrays of a uniformized chunked plan one of whose pad tiles
    points past n_blocks."""
    for cap in range(3, 40):
        arrays, meta = jplan.build_bat_plan_host(dst, n, e_tile=TILE, s_tile=TILE,
                                                 max_chunk_tiles=cap)
        if meta["chunks"] and int(arrays["out_block"].max()) >= meta["n_blocks"]:
            return arrays, meta
    raise AssertionError("no chunk cap puts a pad tile past n_blocks")


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_sddmm_bat_plain_vs_pallas(chunked, ragged):
    """Mirror of test_sddmm_bat_kernel_matches_reference at the kernel
    level: the same plan and padded operands into the JAX kernel
    (interpret mode) and the port's plain version."""
    rng = np.random.default_rng(5 + 2 * chunked + ragged)
    n = 300
    _, dst = _hubby(rng, n, 2000, 600)
    dst = np.sort(dst)
    if chunked:
        arrays, meta = _chunked_host_plan(dst, n)
    else:
        arrays, meta = jplan.build_bat_plan_host(dst, n, e_tile=TILE, s_tile=TILE)
    jbp = jplan.bat_plan_from_host(arrays, meta)
    tbp = tplan.bat_plan_from_host(arrays, meta)
    rows_a = (meta["n_blocks"] + (meta["chunk_blocks"] if chunked else 0)) * TILE
    rows_b = len(dst) if ragged else meta["n_vblocks"] * TILE
    a = rng.standard_normal((rows_a, 128)).astype(np.float32)
    b = rng.standard_normal((rows_b, 128)).astype(np.float32)
    # the JAX kernel clamps a ragged last block to the previous whole one
    # (its caller always pads); the port reads missing rows as zero, which
    # is the JAX kernel on b zero-padded to whole blocks
    b_whole = np.zeros((meta["n_vblocks"] * TILE, 128), np.float32)
    b_whole[:rows_b] = b
    j = jsddmm_bat(jbp, jnp.asarray(a), jnp.asarray(b_whole), interpret=True)
    t = sddmm_bat(tbp, torch.from_numpy(a), torch.from_numpy(b))
    assert t.shape == tuple(j.shape) == ((meta["n_vblocks"] + 1) * TILE,)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL_SDDMM)
    want = (a[dst] * b[: len(dst)]).sum(1)
    np.testing.assert_allclose(t.numpy()[: len(dst)], want, **TOL_SDDMM)
    assert (t.numpy()[len(dst):] == 0).all()


@pytest.mark.parametrize("n_feat", [1, 48])
@pytest.mark.parametrize("chunked", [False, True])
def test_sddmm_fwd_and_sddmm_coo_vs_jax(n_feat, chunked, monkeypatch):
    rng = np.random.default_rng(6 + n_feat + chunked)
    n = 250
    src, dst = _hubby(rng, n, 2000, 1500, hub=3)
    jg, tg = _graphs(n, src, dst, None, chunked, monkeypatch)
    a = rng.standard_normal((n, n_feat)).astype(np.float32)
    b = rng.standard_normal((n, n_feat)).astype(np.float32)
    want_j = jref.sddmm_coo_ref(jg.src, jg.dst, jnp.asarray(a), jnp.asarray(b))
    want_t = tref.sddmm_coo_ref(tg.src, tg.dst, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(want_t.numpy(), np.asarray(want_j), **TOL_SDDMM)
    fwd = tapi._sddmm_bat_fwd(tg.bat, torch.from_numpy(a), torch.from_numpy(b), tg.src)
    assert fwd.shape == (tg.num_edges,)
    np.testing.assert_allclose(fwd.numpy(), np.asarray(want_j), **TOL_SDDMM)
    jfwd = japi._sddmm_bat_fwd(jg.bat, jnp.asarray(a), jnp.asarray(b), jg.src)
    np.testing.assert_allclose(fwd.numpy(), np.asarray(jfwd), **TOL_SDDMM)
    coo = tapi.sddmm_coo(tg.src, tg.dst, torch.from_numpy(a), torch.from_numpy(b), graph=tg)
    np.testing.assert_allclose(coo.numpy(), want_t.numpy(), **TOL_SDDMM)


@pytest.mark.parametrize("chunked", [False, True])
def test_sddmm_coo_grad_vs_jax(chunked, monkeypatch):
    """sddmm_coo(graph=) is differentiable: da is the weighted sum over the
    BAT plan, db the one over the transpose plan."""
    rng = np.random.default_rng(21 + chunked)
    n, F = 200, 24
    src, dst = _hubby(rng, n, 2000, 1500, hub=3)
    jg, tg = _graphs(n, src, dst, None, chunked, monkeypatch)
    a = rng.standard_normal((n, F)).astype(np.float32)
    b = rng.standard_normal((n, F)).astype(np.float32)
    cot = rng.standard_normal(tg.num_edges).astype(np.float32)
    ja, jb = jax.grad(lambda aa, bb: jnp.vdot(jref.sddmm_coo_ref(
        jg.src, jg.dst, aa, bb), jnp.asarray(cot)), argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    out = tapi.sddmm_coo(tg.src, tg.dst, ta, tb, graph=tg)
    torch.vdot(out, torch.from_numpy(cot)).backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ja), **TOL_REF)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jb), **TOL_REF)


@pytest.mark.parametrize("mode", ["unweighted", "static", "dynamic", "w_only"])
@pytest.mark.parametrize("chunked", [False, True])
def test_bat_spmm_grad_vs_jax(mode, chunked, monkeypatch):
    """Mirror of test_bat_spmm_static_dynamic_grad and
    test_gws_weight_grad_uses_sddmm_kernel: dx and dw of the three BAT
    routes against jax.grad of the JAX op (Pallas, interpret mode) and of
    the f32 reference. `w_only`: only the per-call weights need a
    gradient, and the port must still give it."""
    rng = np.random.default_rng(31 + len(mode) + 5 * chunked)
    n, F = 200, 40
    src, dst = _hubby(rng, n, 1000, 1500, hub=3)
    w_static = rng.standard_normal(len(dst)).astype(np.float32)
    jg, tg = _graphs(n, src, dst, w_static if mode == "static" else None, chunked,
                     monkeypatch)
    x = rng.standard_normal((n, F)).astype(np.float32)
    w = rng.standard_normal(len(dst)).astype(np.float32)[np.argsort(dst, kind="stable")]
    cot = rng.standard_normal((n, F)).astype(np.float32)
    weighted = mode in ("dynamic", "w_only")

    def jop(xx, ww, backend):
        if mode == "unweighted":
            return japi.gather_scatter(jg.src, jg.dst, xx, n, graph=jg, backend=backend)
        if mode == "static":
            return japi.segment_spmm(jg, xx, backend=backend)
        return japi.gather_weight_scatter(jg.src, jg.dst, ww, xx, n, graph=jg,
                                          backend=backend)

    def jgrads(backend):
        f = lambda xx, ww: jnp.vdot(jop(xx, ww, backend), jnp.asarray(cot))  # noqa: E731
        return jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))

    jdx_p, jdw_p = jgrads("pallas")
    jdx_r, jdw_r = jgrads("reference")

    tx = torch.from_numpy(x).requires_grad_(mode != "w_only")
    tw = torch.from_numpy(w).requires_grad_(weighted)
    if mode == "unweighted":
        assert tapi.dispatch_path(tg) == "bat"
        out = tapi.gather_scatter(tg.src, tg.dst, tx, n, graph=tg)
    elif mode == "static":
        assert tapi.dispatch_path(tg) == "bat_static"
        out = tapi.segment_spmm(tg, tx)
    else:
        assert tapi.dispatch_path(tg, dynamic_w=True) == "bat_dyn"
        out = tapi.segment_spmm(tg, tx, edge_weight=tw)
    torch.vdot(out.reshape(-1), torch.from_numpy(cot).reshape(-1)).backward()
    if mode == "w_only":
        assert tx.grad is None
    else:
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx_p), **TOL_PALLAS)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx_r), **TOL_REF)
    if weighted:
        assert tw.grad is not None
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw_p), **TOL_PALLAS_DW)
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw_r), **TOL_REF)
    # the same gradient through gather_weight_scatter, the call the JAX
    # package's dw tests use
    if weighted:
        tw2 = torch.from_numpy(w).requires_grad_()
        out2 = tapi.gather_weight_scatter(tg.src, tg.dst, tw2, torch.from_numpy(x), n, graph=tg)
        torch.vdot(out2.reshape(-1), torch.from_numpy(cot).reshape(-1)).backward()
        np.testing.assert_allclose(tw2.grad.numpy(), tw.grad.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_gather_scatter_mean_grad_vs_jax(reduce, monkeypatch):
    rng = np.random.default_rng(41)
    n, F = 150, 16
    src, dst = _hubby(rng, n, 800, 300)
    jg, tg = _graphs(n, src, dst, None, False, monkeypatch)
    x = rng.standard_normal((n, F)).astype(np.float32)
    cot = rng.standard_normal((n, F)).astype(np.float32)
    jdx = jax.grad(lambda xx: jnp.vdot(japi.gather_scatter(
        jg.src, jg.dst, xx, n, reduce=reduce, graph=jg, backend="reference"),
        jnp.asarray(cot)))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out = tapi.gather_scatter(tg.src, tg.dst, tx, n, reduce=reduce, graph=tg)
    torch.vdot(out.reshape(-1), torch.from_numpy(cot).reshape(-1)).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **TOL_REF)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_bat_index_scatter_vs_jax(chunked, reduce):
    """Mirror of test_bat_index_scatter_chunked (wide width): forward and
    gradient over an unchunked and a uniformized chunked BatPlan."""
    rng = np.random.default_rng(92 + chunked)
    nnz, n_seg, n_feat = 3003, 400, 100
    idx = np.sort(rng.integers(0, n_seg, nnz)).astype(np.int32)
    vals = rng.standard_normal((nnz, n_feat)).astype(np.float32)
    cot = rng.standard_normal((n_seg, n_feat)).astype(np.float32)
    kw = dict(e_tile=TILE, s_tile=TILE, max_chunk_tiles=7 if chunked else 8192)
    arrays, meta = jplan.build_bat_plan_host(idx, n_seg, **kw)
    assert bool(meta["chunks"]) == chunked
    jbp = jplan.bat_plan_from_host(arrays, meta)
    tbp = tplan.bat_plan_from_host(arrays, meta)

    def jf(v, backend):
        return japi.index_scatter(v, jnp.asarray(idx), n_seg, reduce=reduce, plan=jbp,
                                  backend=backend)

    jp = jf(jnp.asarray(vals), "pallas")
    jr = jf(jnp.asarray(vals), "reference")
    jg = jax.grad(lambda v: jnp.vdot(jf(v, "pallas"), jnp.asarray(cot)))(jnp.asarray(vals))
    tv = torch.from_numpy(vals).requires_grad_()
    t = tapi.index_scatter(tv, torch.from_numpy(idx), n_seg, reduce=reduce, plan=tbp)
    assert t.shape == (n_seg, n_feat)
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp), **TOL_PALLAS)
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(jr), **TOL_REF)
    torch.vdot(t.reshape(-1), torch.from_numpy(cot).reshape(-1)).backward()
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jg), **TOL_REF)
    # without a plan: the plain reference
    r = tapi.index_scatter(torch.from_numpy(vals), torch.from_numpy(idx), n_seg, reduce=reduce)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), **TOL_REF)


def test_index_scatter_axis_and_checks():
    rng = np.random.default_rng(3)
    idx = np.sort(rng.integers(0, 50, 300)).astype(np.int32)
    bp = tplan.build_bat_plan(idx, 50, e_tile=TILE, s_tile=TILE, device="cpu")
    vals = torch.from_numpy(rng.standard_normal((3, 300, 5)).astype(np.float32))
    out = tapi.index_scatter(vals, torch.from_numpy(idx), 50, plan=bp, axis=1)
    exp = jref.segment_reduce_ref(jnp.asarray(np.moveaxis(vals.numpy(), 1, 0)),
                                  jnp.asarray(idx), 50)
    np.testing.assert_allclose(out.numpy(), np.moveaxis(np.asarray(exp), 0, 1), **TOL_REF)
    with pytest.raises(ValueError, match="num_segments"):
        tapi.index_scatter(vals[0], torch.from_numpy(idx), 60, plan=bp)


def test_sddmm_wrapper_rules_and_unique_tiles():
    dst = np.array([0, 1, 1], np.int32)
    arrays, meta = tplan.build_bat_plan_host(dst, 4, e_tile=32, s_tile=4)
    bp = tplan.bat_plan_from_host(arrays, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        sddmm_bat(bp, torch.empty(4, 128, device="meta"), torch.empty(3, 128, device="meta"))
    # the kernel writes each edge from its one owner tile: a plan that
    # repeats a (vblock, out_block) pair is refused when it is made
    dup = dict(arrays, out_block=np.repeat(arrays["out_block"], 2),
               vblock=np.repeat(arrays["vblock"], 2))
    with pytest.raises(ValueError, match="increasing vblock"):
        tplan.bat_plan_from_host(dup, meta)
    # ...and in the plain version a repeated tile would count its edges twice
    bp2 = dataclasses.replace(bp, out_block=torch.from_numpy(dup["out_block"]),
                              vblock=torch.from_numpy(dup["vblock"]))
    a = torch.ones(4, 128)
    b = torch.ones(32, 128)
    assert sddmm_bat_plain(bp, a, b)[:3].tolist() == [128.0] * 3
    assert sddmm_bat_plain(bp2, a, b)[:3].tolist() == [256.0] * 3


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("grads", ["x", "x_and_w", "w"])
def test_reference_path_grad_chunked_vs_jax(reduce, grads, monkeypatch):
    """The port's plain reference path (chunked forward, hand-written
    backward) against jax.grad of the JAX reference, with chunks of 37
    edges: 10 full chunks and a ragged one of 30. Tolerance TOL_REF."""
    rng = np.random.default_rng(17)
    n, nnz, f = 50, 400, 9
    monkeypatch.setattr(tref, "REF_CHUNK_BYTES", 37 * f * 4)
    src, dst = _hubby(rng, n, nnz - 60, 60)
    dst = np.sort(dst).astype(np.int32)
    x = rng.standard_normal((n, f)).astype(np.float32)
    w = rng.standard_normal(nnz).astype(np.float32)
    cot = rng.standard_normal((n, f)).astype(np.float32)
    js, jd = jnp.asarray(src), jnp.asarray(dst)
    if grads == "x":
        jdx = jax.grad(lambda xx: jnp.vdot(jref.gather_scatter_ref(js, jd, xx, n, reduce),
                                           jnp.asarray(cot)))(jnp.asarray(x))
        jdw = None
    else:
        jdx, jdw = jax.grad(lambda xx, ww: jnp.vdot(jref.gather_weight_scatter_ref(
            js, jd, ww, xx, n, reduce), jnp.asarray(cot)), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(grads != "w")
    ts, td = torch.from_numpy(src), torch.from_numpy(dst)
    if grads == "x":
        out = tref.gather_scatter_ref(ts, td, tx, n, reduce)
    else:
        tw = torch.from_numpy(w).requires_grad_()
        out = tref.gather_weight_scatter_ref(ts, td, tw, tx, n, reduce)
    torch.vdot(out.reshape(-1), torch.from_numpy(cot).reshape(-1)).backward()
    if grads != "w":
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **TOL_REF)
    else:
        assert tx.grad is None
    if jdw is not None:
        assert tw.grad.dtype == torch.float32
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **TOL_REF)
