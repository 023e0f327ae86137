"""max, min and prod on every op, `csr_gws`, `csr_spmm_ref`, `coo_to_csr`
and `csr_to_coo`, against the JAX package.

The same numpy inputs, made from a seed, go through `geot_tpu` and
`geot_tpu_torch` on the CPU. max, min and prod are plain routes in both
packages (`dispatch_path` 'xla'): the port reduces the dst-sorted runs
with `torch.segment_reduce`, the reference with `jax.ops.segment_*`, so
max and min agree exactly and prod within the f32 rounding of a few
products (rtol 1e-5). Empty segments give 0 for max and min and 1 for
prod in both. Gradients are held against `jax.grad` on inputs without
ties or zeros (no duplicate edges, continuous values); JAX has no
gradient of a scatter-multiply over repeated indices, so prod's is
jax.grad of the same products taken densely (`_dense_prod`). The sums of
`csr_gws` over a graph run the BAT or slot kernels' plain versions here
and JAX's Pallas kernels in interpret mode: tolerance 2e-3, the bound of
tests/test_ops.py for that path; without a graph both are the plain
reference, at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geot_tpu.graph import preprocess as jpre
from geot_tpu.graph.structures import build_graph as jbuild_graph
from geot_tpu.ops import api as japi
from geot_tpu.ops import reference as jref
from geot_tpu_torch.graph import preprocess as tpre
from geot_tpu_torch.graph.structures import build_graph as tbuild_graph
from geot_tpu_torch.ops import api as tapi
from geot_tpu_torch.ops import reference as tref

REDUCES = ["max", "min", "prod"]
TOL = {"max": dict(rtol=0, atol=0), "min": dict(rtol=0, atol=0),
       "prod": dict(rtol=1e-5, atol=1e-6)}
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
TOL_PALLAS = dict(rtol=2e-3, atol=2e-3)
TILES = dict(e_tile=64, s_tile=32, bat_e_tile=64, bat_s_tile=32, feature_hint=128)


def _edges(rng, n, nnz, n_empty=20):
    """Distinct (src, dst) pairs sorted by dst, the last n_empty nodes with
    no in-edge."""
    pairs = np.unique(np.stack([rng.integers(0, n - n_empty, nnz),
                                rng.integers(0, n, nnz)], axis=1), axis=0)
    return pairs[:, 1].astype(np.int32), pairs[:, 0].astype(np.int32)


def _dense_prod(vals, index, n):
    """The segment products of vals [nnz, ...] by index as jnp.prod over a
    dense [n, max run, ...] array of ones (differentiable by jax.grad)."""
    index = np.asarray(index)
    order = np.argsort(index, kind="stable")
    idx = index[order]
    pos = np.arange(len(idx)) - np.searchsorted(idx, idx)
    width = int(pos.max()) + 1 if len(idx) else 1
    dense = jnp.ones((n, width) + vals.shape[1:], vals.dtype)
    return jnp.prod(dense.at[idx, pos].set(vals[order]), axis=1)


def _close(t, j, reduce):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL[reduce])


@pytest.mark.parametrize("reduce", REDUCES)
@pytest.mark.parametrize("sort", [True, False])
def test_segment_reduce_ref_vs_jax(reduce, sort):
    rng = np.random.default_rng(1)
    n, nnz = 60, 400
    index = rng.integers(-3, n - 10, nnz).astype(np.int32)  # some dropped, 10+ empty
    if sort:
        index = np.sort(index)
    src = (rng.standard_normal((nnz, 5)) * 0.5 + 1.0).astype(np.float32)
    t = tref.segment_reduce_ref(torch.from_numpy(src), torch.from_numpy(index), n, reduce)
    keep = (index >= 0) & (index < n)
    j = jref.segment_reduce_ref(jnp.asarray(src[keep]), jnp.asarray(index[keep]), n, reduce,
                                indices_are_sorted=sort)
    _close(t, j, reduce)
    empty = np.bincount(index[keep], minlength=n) == 0
    assert empty.sum() >= 10
    np.testing.assert_array_equal(t.numpy()[empty], 1.0 if reduce == "prod" else 0.0)


@pytest.mark.parametrize("reduce", REDUCES)
def test_index_scatter_vs_jax_with_grad(reduce):
    rng = np.random.default_rng(2)
    n, nnz = 50, 200
    index = rng.integers(0, n - 8, nnz).astype(np.int32)  # unsorted
    src = rng.uniform(0.5, 1.5, (nnz, 3)).astype(np.float32)
    src *= rng.choice([-1.0, 1.0], src.shape).astype(np.float32)
    cot = rng.standard_normal((n, 3)).astype(np.float32)
    xt = torch.from_numpy(src).requires_grad_()
    t = tapi.index_scatter(xt, torch.from_numpy(index), n, reduce=reduce, sorted=False)
    (t * torch.from_numpy(cot)).sum().backward()

    def f(s):
        if reduce == "prod":
            return jnp.sum(_dense_prod(s, index, n) * cot)
        return jnp.sum(japi.index_scatter(s, jnp.asarray(index), n, reduce=reduce,
                                          sorted=False) * cot)

    jo = japi.index_scatter(jnp.asarray(src), jnp.asarray(index), n, reduce=reduce,
                            sorted=False)
    _close(t, jo, reduce)
    gj = jax.grad(f)(jnp.asarray(src))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), **GRAD_TOL)


@pytest.mark.parametrize("reduce", REDUCES)
@pytest.mark.parametrize("weighted", [False, True])
def test_fused_ops_and_segment_spmm_vs_jax_with_grads(reduce, weighted):
    """gather_scatter / gather_weight_scatter (with and without a graph),
    segment_spmm over a graph, all on the plain route; dx and dw against
    jax.grad."""
    rng = np.random.default_rng(3 + weighted)
    n = 120
    src, dst = _edges(rng, n, 300)
    nnz = len(src)
    w = rng.uniform(0.5, 1.5, nnz).astype(np.float32) if weighted else None
    x = rng.uniform(0.5, 1.5, (n, 6)).astype(np.float32)
    x *= rng.choice([-1.0, 1.0], x.shape).astype(np.float32)
    cot = rng.standard_normal((n, 6)).astype(np.float32)
    jg = jbuild_graph(src, dst, n, edge_weight=w, assume_sorted=True, layouts=("bat",), **TILES)
    tg = tbuild_graph(src, dst, n, edge_weight=w, assume_sorted=True, layouts=("bat",),
                      device="cpu", **TILES)
    assert tapi.dispatch_path(tg, reduce=reduce) == japi.dispatch_path(
        jg, reduce=reduce, backend="pallas") == "xla"

    def jax_fns(xx, ww):
        js, jd = jnp.asarray(src), jnp.asarray(dst)
        if ww is None:
            a = japi.gather_scatter(js, jd, xx, n, reduce=reduce)
        else:
            a = japi.gather_weight_scatter(js, jd, ww, xx, n, reduce=reduce)
        return a, japi.segment_spmm(jg, xx, ww, reduce=reduce, backend="pallas")

    def torch_fns(xx, ww, graph):
        ts, td = torch.from_numpy(src), torch.from_numpy(dst)
        if ww is None:
            a = tapi.gather_scatter(ts, td, xx, n, reduce=reduce, graph=graph)
        else:
            a = tapi.gather_weight_scatter(ts, td, ww, xx, n, reduce=reduce, graph=graph)
        return a, tapi.segment_spmm(tg, xx, ww, reduce=reduce)

    jw = None if w is None else jnp.asarray(w)
    jouts = jax_fns(jnp.asarray(x), jw)
    for graph in (None, tg):
        xt = torch.from_numpy(x).requires_grad_()
        wt = None if w is None else torch.from_numpy(w).requires_grad_()
        touts = torch_fns(xt, wt, graph)
        for i, (t, j) in enumerate(zip(touts, jouts)):
            _close(t, j, reduce)
            loss = (t * torch.from_numpy(cot)).sum()
            grads = torch.autograd.grad(loss, [xt] + ([wt] if wt is not None else []))
            argn = (0, 1) if w is not None else (0,)
            if reduce == "prod":
                def jf(xx, ww):
                    v = xx[src] if ww is None else xx[src] * ww[:, None]
                    return jnp.sum(_dense_prod(v, dst, n) * cot)
            else:
                def jf(xx, ww):
                    return jnp.sum(jax_fns(xx, ww)[i] * cot)
            jgr = jax.grad(jf, argnums=argn)(jnp.asarray(x), jw)
            for a, b in zip(grads, jgr):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


@pytest.mark.parametrize("reduce", REDUCES + ["sum"])
def test_mh_spmm_ref_vs_jax(reduce):
    rng = np.random.default_rng(6)
    n = 80
    src, dst = _edges(rng, n, 250)
    H, D = 3, 4
    x = rng.uniform(0.5, 1.5, (n, H, D)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (len(src), H)).astype(np.float32)
    t = tref.mh_spmm_ref(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w),
                         torch.from_numpy(x), n, reduce)
    j = jref.mh_spmm_ref(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), jnp.asarray(x), n,
                         reduce)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL.get(reduce, GRAD_TOL))


def test_coo_csr_conversions_vs_jax():
    rng = np.random.default_rng(7)
    n = 40
    row = rng.integers(0, n - 5, 300).astype(np.int32)
    ptr = tpre.coo_to_csr(torch.from_numpy(row), n)
    assert ptr.dtype == torch.int32
    np.testing.assert_array_equal(ptr.numpy(), np.asarray(jpre.coo_to_csr(jnp.asarray(row), n)))
    nnz = int(ptr[-1])
    back = tpre.csr_to_coo(ptr, nnz)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), np.asarray(jpre.csr_to_coo(
        jnp.asarray(ptr.numpy()), nnz)))
    np.testing.assert_array_equal(back.numpy(), np.sort(row))


def _csr_case(seed=8):
    rng = np.random.default_rng(seed)
    n = 150
    src, dst = _edges(rng, n, 900, n_empty=0)
    w = rng.standard_normal(len(src)).astype(np.float32)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    ptr = np.array(jpre.coo_to_csr(jnp.asarray(dst), n))
    return n, src, dst, w, x, ptr


def test_csr_spmm_ref_and_csr_gws_without_graph():
    n, src, dst, w, x, ptr = _csr_case()
    args = (ptr, src, w, x)
    j = jref.csr_spmm_ref(*map(jnp.asarray, args))
    t1 = tref.csr_spmm_ref(*map(torch.from_numpy, args))
    t2 = tapi.csr_gws(*map(torch.from_numpy, args))
    for t in (t1, t2):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(japi.csr_gws(*map(jnp.asarray, args))),
                               np.asarray(j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layouts", [("bat",), ("bat", "slot")])
def test_csr_gws_with_graph_vs_jax_and_refusal(layouts):
    """With the graph built from the matrix: the per-call-weight route of
    `gather_weight_scatter` over the graph's plans, dx and dw against
    jax.grad; a matrix of another nnz, or more rows than the graph has
    nodes, is refused by both packages."""
    n, src, dst, w, x, ptr = _csr_case(9)
    jg = jbuild_graph(src, dst, n, assume_sorted=True, layouts=layouts, **TILES)
    tg = tbuild_graph(src, dst, n, assume_sorted=True, layouts=layouts, device="cpu", **TILES)
    cot = np.random.default_rng(10).standard_normal((n, 16)).astype(np.float32)

    def jf(xx, ww):
        return jnp.vdot(japi.csr_gws(jnp.asarray(ptr), jnp.asarray(src), ww, xx, graph=jg,
                                     backend="pallas"), cot)

    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = tapi.csr_gws(torch.from_numpy(ptr), torch.from_numpy(src), wt, xt, graph=tg)
    jo = japi.csr_gws(jnp.asarray(ptr), jnp.asarray(src), jnp.asarray(w), jnp.asarray(x),
                      graph=jg, backend="pallas")
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo), **TOL_PALLAS)
    (out * torch.from_numpy(cot)).sum().backward()
    gx, gw = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL_PALLAS)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw), **TOL_PALLAS)
    for bad_col, bad_rows in ((src[:-1], None), (src, n + 1)):
        with pytest.raises(ValueError):
            tapi.csr_gws(torch.from_numpy(ptr), torch.from_numpy(bad_col),
                         torch.from_numpy(w[: len(bad_col)]), torch.from_numpy(x),
                         num_rows=bad_rows, graph=tg)
        with pytest.raises(ValueError):
            japi.csr_gws(jnp.asarray(ptr), jnp.asarray(bad_col), jnp.asarray(w[: len(bad_col)]),
                         jnp.asarray(x), num_rows=bad_rows, graph=jg, backend="pallas")


def test_unknown_reduce_raises():
    x = torch.ones(4, 2)
    idx = torch.tensor([0, 1, 1, 2])
    with pytest.raises(ValueError):
        tref.segment_reduce_ref(x, idx, 3, "median")
