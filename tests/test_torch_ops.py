"""The port's BAT segment sum and segment_spmm against the JAX package.

Same inputs (numpy, from a seed) go through both. The JAX side runs its
Pallas kernels in interpret mode (`backend="pallas"`), whose one-hot
products use a hi/lo bf16 split of the values (~2^-16 relative,
`pallas_segment.py:68-87`): tolerance rtol/atol 2e-3, as `test_ops.py`
uses for the BAT path. Against the f32 XLA reference: 1e-5; where chunks
split a hub window (1500 edges into one row) the overlap-add regroups that
row's f32 sum, and the tolerance is the 1e-4 of the reference's own
hub-split test (`test_ops.py:362`).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geot_tpu.graph import plan as jplan
from geot_tpu.graph.structures import build_graph as jbuild_graph
from geot_tpu.ops import api as japi
from geot_tpu.ops import reference as jref
from geot_tpu.ops.pallas_segment import bat_segment_sum as jbat_segment_sum
from geot_tpu_torch.graph import plan as tplan
from geot_tpu_torch.graph.structures import build_graph as tbuild_graph
from geot_tpu_torch.ops import api as tapi
from geot_tpu_torch.ops import reference as tref
from geot_tpu_torch.ops.bat_kernels import bat_segment_sum, bat_segment_sum_plain

TOL_PALLAS = dict(rtol=2e-3, atol=2e-3)
TOL_F32 = dict(rtol=1e-5, atol=1e-5)
TOL_F32_HUB_SPLIT = dict(rtol=1e-4, atol=1e-4)


def _hubby(rng, n, nnz, hub_edges, hub=7):
    dst = np.concatenate([np.full(hub_edges, hub, np.int32),
                          rng.integers(0, n, nnz).astype(np.int32)])
    src = rng.integers(0, n, len(dst)).astype(np.int32)
    return src, dst


@pytest.mark.parametrize("f_pad", [128, 256])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_bat_segment_sum_plain_vs_pallas(f_pad, weighted, ragged):
    rng = np.random.default_rng(f_pad + 2 * weighted + ragged)
    n, e_tile, s_tile = 150, 64, 32
    _, dst = _hubby(rng, n, 700, 200)
    dst = np.sort(dst)
    nnz = len(dst)
    arrays, meta = jplan.build_bat_plan_host(dst, n, e_tile=e_tile, s_tile=s_tile)
    jbp = jplan.bat_plan_from_host(arrays, meta)
    tbp = tplan.bat_plan_from_host(arrays, meta)
    # ragged: exactly nnz rows (the last value block is partial); else
    # padded to whole blocks
    rows = nnz if ragged else meta["n_vblocks"] * e_tile
    assert (rows % e_tile != 0) == ragged
    vals = rng.standard_normal((rows, f_pad)).astype(np.float32)
    w = rng.standard_normal(nnz).astype(np.float32) if weighted else None
    f_tile = 256 if f_pad == 256 else 128
    j = jbat_segment_sum(jbp, jnp.asarray(vals), None if w is None else jnp.asarray(w),
                         f_tile=f_tile, interpret=True)
    t = bat_segment_sum(tbp, torch.from_numpy(vals),
                        None if w is None else torch.from_numpy(w))
    assert t.shape == tuple(j.shape) == (meta["n_blocks"] * s_tile, f_pad)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL_PALLAS)
    # and against the f32 oracle on the real rows
    wt = torch.ones(nnz) if w is None else torch.from_numpy(w)
    exp = tref.gather_weight_scatter_ref(
        torch.arange(nnz), torch.from_numpy(dst), wt,
        torch.from_numpy(vals[:nnz]), meta["n_blocks"] * s_tile)
    np.testing.assert_allclose(t.numpy(), exp.numpy(), **TOL_F32)


def _graphs(n, src, dst, w, budget, monkeypatch, e_tile=32, s_tile=32):
    monkeypatch.setenv("GEOT_MAX_CHUNK_BYTES", str(budget))
    kw = dict(e_tile=e_tile, s_tile=s_tile, bat_e_tile=e_tile, bat_s_tile=s_tile,
              feature_hint=128)
    jg = jbuild_graph(src, dst, n, edge_weight=w, layouts=("bat",), **kw)
    tg = tbuild_graph(src, dst, n, edge_weight=w, max_chunk_bytes=budget, layouts=("bat",),
                      device="cpu", **kw)
    return jg, tg


@pytest.mark.parametrize("n_feat", [40, 128, 256])
@pytest.mark.parametrize("mode", ["unweighted", "static", "dynamic"])
@pytest.mark.parametrize("chunked", [False, True])
def test_segment_spmm_vs_jax(n_feat, mode, chunked, monkeypatch):
    rng = np.random.default_rng(n_feat + len(mode) + 7 * chunked)
    n = 100
    src, dst = _hubby(rng, n, 400, 1500, hub=3)
    w_static = rng.standard_normal(len(dst)).astype(np.float32)
    # 8 tiles of 32 edges per chunk at F 128: the ~47-tile hub window is
    # split across chunks
    budget = 8 * 32 * 128 * 4 if chunked else 1 << 30
    jg, tg = _graphs(n, src, dst, w_static if mode == "static" else None,
                     budget, monkeypatch)
    if chunked:
        ch = tg.bat.chunks
        assert len(ch) > 2
        assert any(b[2] < a[3] for a, b in zip(ch[:-1], ch[1:])), "no shared window"
    else:
        assert not tg.bat.chunks
    x = rng.standard_normal((n, n_feat)).astype(np.float32)
    w_dyn = rng.standard_normal(len(dst)).astype(np.float32)
    wj = jnp.asarray(w_dyn[np.argsort(dst, kind="stable")]) if mode == "dynamic" else None
    wt = torch.from_numpy(np.array(wj)) if mode == "dynamic" else None
    path = tapi.dispatch_path(tg, dynamic_w=wt is not None)
    assert path == {"unweighted": "bat", "static": "bat_static", "dynamic": "bat_dyn"}[mode]
    assert path == japi.dispatch_path(jg, dynamic_w=wj is not None, backend="pallas")
    j = japi.segment_spmm(jg, jnp.asarray(x), edge_weight=wj, backend="pallas")
    with torch.inference_mode():
        t = tapi.segment_spmm(tg, torch.from_numpy(x), edge_weight=wt)
    assert t.shape == (n, n_feat)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL_PALLAS)
    w_ref = {"unweighted": jnp.ones(len(dst), jnp.float32), "static": jg.edge_weight,
             "dynamic": wj}[mode]
    exp = jref.gather_weight_scatter_ref(jg.src, jg.dst, w_ref, jnp.asarray(x), n)
    np.testing.assert_allclose(t.numpy(), np.asarray(exp),
                               **(TOL_F32_HUB_SPLIT if chunked else TOL_F32))


def test_chunked_hub_window_overlap_add():
    """Mirror of test_ops.test_chunked_hub_window_overlap_add on the BAT
    plan: ragged chunks from compute_chunks cut the hub window mid-window.
    The port sums the plan whole by its edge-row schedule, so the chunked
    plan sums exactly what the whole one does, and the chunks (the TPU's)
    are not read: a chunk list out of step with the plan changes
    nothing."""
    rng = np.random.default_rng(61)
    n, F = 100, 24
    dst = np.concatenate([np.full(1500, 3, np.int32),
                          rng.integers(0, n, 400).astype(np.int32)])
    src = rng.integers(0, n, len(dst)).astype(np.int32)
    w = rng.standard_normal(len(dst)).astype(np.float32)
    g = tbuild_graph(src, dst, n, edge_weight=w, bat_e_tile=32, bat_s_tile=32,
                     layouts=("bat",), device="cpu")
    ch = tplan.compute_chunks(g.bat.out_block.numpy(), 8)
    assert any(w1 - w0 == 1 and (t1 - t0) <= 8 for t0, t1, w0, w1 in ch)
    assert any(b[2] < a[3] for a, b in zip(ch[:-1], ch[1:]))
    g2 = dataclasses.replace(g, bat=tplan.with_chunks(g.bat, ch))
    x = torch.from_numpy(rng.standard_normal((n, F)).astype(np.float32))
    with torch.no_grad():
        out = tapi.segment_spmm(g2, x)
        whole = tapi.segment_spmm(g, x)
    exp = jref.gather_weight_scatter_ref(
        jnp.asarray(g.src.numpy()), jnp.asarray(g.dst.numpy()),
        jnp.asarray(g.edge_weight.numpy()), jnp.asarray(x.numpy()), n)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL_F32_HUB_SPLIT)
    torch.testing.assert_close(out, whole, rtol=0, atol=0)
    with torch.no_grad():
        stale = tapi.segment_spmm(
            dataclasses.replace(g, bat=dataclasses.replace(g.bat, chunks=ch)), x)
    torch.testing.assert_close(stale, whole, rtol=0, atol=0)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_reference_ops_vs_jax(reduce, weighted):
    rng = np.random.default_rng(13)
    n, nnz, f = 50, 400, 9
    src = rng.integers(0, n, nnz).astype(np.int32)
    dst = rng.integers(0, n, nnz).astype(np.int32)
    x = rng.standard_normal((n, f)).astype(np.float32)
    w = rng.standard_normal(nnz).astype(np.float32)
    if weighted:
        j = jref.gather_weight_scatter_ref(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
                                           jnp.asarray(x), n, reduce)
        t = tref.gather_weight_scatter_ref(torch.from_numpy(src), torch.from_numpy(dst),
                                           torch.from_numpy(w), torch.from_numpy(x), n, reduce)
    else:
        j = jref.gather_scatter_ref(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(x), n, reduce)
        t = tref.gather_scatter_ref(torch.from_numpy(src), torch.from_numpy(dst),
                                    torch.from_numpy(x), n, reduce)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL_F32)


def test_segment_spmm_mean_and_reference_backend(monkeypatch):
    rng = np.random.default_rng(17)
    n = 80
    src, dst = _hubby(rng, n, 500, 100)
    jg, tg = _graphs(n, src, dst, None, 1 << 30, monkeypatch)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    j = japi.segment_spmm(jg, jnp.asarray(x), reduce="mean", backend="pallas")
    t = tapi.segment_spmm(tg, torch.from_numpy(x), reduce="mean")
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL_PALLAS)
    assert tapi.dispatch_path(tg, backend="reference") == "xla"
    r = tapi.segment_spmm(tg, torch.from_numpy(x), backend="reference")
    np.testing.assert_allclose(
        r.numpy(), np.asarray(japi.segment_spmm(jg, jnp.asarray(x), backend="reference")),
        **TOL_F32)
    # max takes the plain route in both packages (tests/test_torch_reduce.py)
    assert tapi.dispatch_path(tg, reduce="max") == "xla"
    np.testing.assert_array_equal(
        tapi.segment_spmm(tg, torch.from_numpy(x), reduce="max").numpy(),
        np.asarray(japi.segment_spmm(jg, jnp.asarray(x), reduce="max", backend="pallas")))


def test_plain_version_drops_pad_and_sentinel_edges():
    """-1 pad ids, out-of-window ids and the sentinel block add nothing,
    and every output row is written (zeros where no edge lands)."""
    dst = np.array([0, 0, 5, 9, 9, 9], np.int32)
    arrays, meta = tplan.build_bat_plan_host(dst, 40, e_tile=4, s_tile=4)
    bp = tplan.bat_plan_from_host(arrays, meta)
    vals = torch.arange(6 * 128, dtype=torch.float32).reshape(6, 128)
    out = bat_segment_sum_plain(bp, vals)
    exp = torch.zeros(40, 128)
    for e, d in enumerate(dst):
        exp[d] += vals[e]
    torch.testing.assert_close(out, exp, rtol=0, atol=0)
    # a plan whose extra tile points at the sentinel block sums the same
    ob = np.concatenate([arrays["out_block"], [arrays["out_block"][-1]]]).astype(np.int32)
    vb = np.concatenate([arrays["vblock"], [meta["n_vblocks"]]]).astype(np.int32)
    bp2 = tplan.bat_plan_from_host(dict(arrays, out_block=ob, vblock=vb), meta)
    torch.testing.assert_close(bat_segment_sum_plain(bp2, vals), exp, rtol=0, atol=0)


def test_wrapper_device_rules():
    dst = np.array([0, 1, 1], np.int32)
    arrays, meta = tplan.build_bat_plan_host(dst, 4, e_tile=32, s_tile=4)
    bp = tplan.bat_plan_from_host(arrays, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        bat_segment_sum(bp, torch.empty(3, 128, device="meta"))
    # segment_spmm takes gradients (transpose-plan backward): d sum(out)/dx
    # is each node's out-degree, in every column
    x = torch.zeros(4, 8, requires_grad=True)
    g = tbuild_graph(np.array([0, 1, 2], np.int32), dst, 4, layouts=("bat",), device="cpu")
    tapi.segment_spmm(g, x).sum().backward()
    torch.testing.assert_close(x.grad, torch.tensor([1.0, 1, 1, 0])[:, None].expand(4, 8),
                               rtol=0, atol=0)
    # a window whose real tiles go back in vblock is refused: the kernel
    # meets a window's edges in dst order
    dst2 = np.array([0] * 40 + [1] * 30, np.int32)
    a2, m2 = tplan.build_bat_plan_host(dst2, 4, e_tile=32, s_tile=4)
    assert list(a2["out_block"]) == [0, 0, 0]
    bad = dict(a2, vblock=a2["vblock"][::-1].copy())
    with pytest.raises(ValueError, match="increasing vblock"):
        tplan.bat_plan_from_host(bad, m2)
