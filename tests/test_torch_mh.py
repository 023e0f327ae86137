"""The port's multi-head path against the JAX package: the plain
`plan_segment_sum_mh` against its Pallas kernel, `mh_spmm` and
`mh_spmm_transposed` with their gradients, `segment_softmax`, and
`gat_attention_spmm` by both of its routes, chunked and not.

Inputs come from numpy with a seed and go through both packages; JAX runs
its Pallas kernels in interpret mode. Tolerances: the plain kernel is held
to 1e-4 * sum|terms| + 1e-5 per element (the Pallas f32 kernels multiply
through a bf16 hi/lo split); mh_spmm to rtol/atol 2e-4 (tests/test_ops.py);
segment_softmax to 1e-5; GAT forward to 1e-4 and its gradients to rtol
1e-3 / atol 1e-4, as the JAX test holds its own.
"""

import dataclasses

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
from geot_tpu.ops import reference as jref
from geot_tpu_torch.graph import plan as tplan
from geot_tpu_torch.graph.structures import build_graph as tbuild_graph
from geot_tpu_torch.models import prepare_graph
from geot_tpu_torch.ops import api as tapi
from geot_tpu_torch.ops import reference as tref

TOL = dict(rtol=2e-4, atol=2e-4)
TOL_GAT = dict(rtol=1e-4, atol=1e-4)
TOL_GAT_GRAD = dict(rtol=1e-3, atol=1e-4)
HD_CASES = [(4, 8), (4, 64), (2, 100), (8, 32), (4, 16), (3, 96)]  # test_mh_spmm's


def _graph_edges(rng, n_nodes, nnz, power=1.0):
    ranks = np.arange(1, n_nodes + 1, dtype=np.float64)
    p = ranks ** -power
    p /= p.sum()
    dst = np.sort(rng.choice(n_nodes, size=nnz, p=p)).astype(np.int32)
    src = rng.integers(0, n_nodes, size=nnz, dtype=np.int32)
    return src, dst


def _assert_abs_sum(t, j, a):
    bad = np.abs(t - j) > 1e-4 * a + 1e-5
    assert not bad.any(), (int(bad.sum()), float(np.abs(t - j).max()))


@pytest.mark.parametrize("H,D", HD_CASES)
def test_plain_mh_matches_pallas_interpret(H, D):
    """plan_segment_sum_mh_plain against the Pallas mh kernel in interpret
    mode on the same plan; a third of the (slot, head) weights exactly 0,
    on chosen heads only (a slot stays live while any head is not 0). The
    Pallas kernel takes its lanes padded to its feature tile; the port
    reads H*D columns."""
    rng = np.random.default_rng(H * 100 + D)
    n = 400
    src, dst = _graph_edges(rng, n, 1500)
    kw = dict(e_tile=64, s_tile=128, num_src_nodes=n)
    jp = jplan.build_segment_plan(dst, src, n, **kw)
    tp = tplan.build_segment_plan(dst, src, n, **kw, device="cpu")
    T, E, F = tp.num_tiles, tp.e_tile, H * D
    mask = tp.mask.numpy().reshape(-1, 1)
    w = (rng.standard_normal((T * E, H)) * mask).astype(np.float32)
    w[rng.random((T * E, H)) < 1 / 3] = 0.0
    v = rng.standard_normal((T * E, F)).astype(np.float32)
    f_pad = F if (F < 128 and F % 8 == 0) else -(-F // 128) * 128
    j = jps.plan_segment_sum_mh(jp, jnp.asarray(np.pad(v, ((0, 0), (0, f_pad - F)))),
                                jnp.asarray(w), D, interpret=True)
    t = tref.plan_segment_sum_mh_plain(tp, torch.from_numpy(v), torch.from_numpy(w), D)
    a = tref.plan_segment_sum_mh_plain(tp, torch.from_numpy(np.abs(v)),
                                       torch.from_numpy(np.abs(w)), D)
    assert t.shape == (tp.n_blocks * tp.s_tile, F)
    _assert_abs_sum(t.numpy(), np.asarray(j)[:, :F], a.numpy())


def _mh_graphs(rng, n=120, nnz=900):
    src, dst = _graph_edges(rng, n, nnz)
    kw = dict(e_tile=128, s_tile=128, bat_e_tile=128, bat_s_tile=128, layouts=("slot",),
              assume_sorted=True)
    return (jbuild_graph(src, dst, n, **kw), tbuild_graph(src, dst, n, device="cpu", **kw),
            src, dst, n)


@pytest.mark.parametrize("H,D", HD_CASES)
def test_mh_spmm_matches_jax(H, D):
    """Mirror of tests/test_ops.py::test_mh_spmm: mh_spmm and
    mh_spmm_transposed over the graph's slot plans against JAX's Pallas
    path and the numpy oracle, with dx and dw against jax.grad."""
    rng = np.random.default_rng(5)
    jg, tg, src, dst, n = _mh_graphs(rng)
    w = rng.standard_normal((len(src), H)).astype(np.float32)
    x = rng.standard_normal((n, H, D)).astype(np.float32)
    cot = rng.standard_normal((n, H, D)).astype(np.float32)
    expect = np.zeros((n, H, D))
    np.add.at(expect, dst, x[src].astype(np.float64) * w[:, :, None])

    def jloss(xx, ww):
        out = japi.mh_spmm(jg.src, jg.dst, ww, xx, n, graph=jg, backend="pallas")
        return jnp.vdot(out, jnp.asarray(cot)), out

    (_, jout), (jdx, jdw) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = tapi.mh_spmm(tg.src, tg.dst, wt, xt, n, graph=tg)
    assert out.shape == (n, H, D)
    np.testing.assert_allclose(out.detach().numpy(), expect, **TOL)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    torch.vdot(out.reshape(-1), torch.from_numpy(cot).reshape(-1)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw), **TOL)
    out_t = tapi.mh_spmm_transposed(tg.src, tg.dst, torch.from_numpy(np.ascontiguousarray(w.T)),
                                    torch.from_numpy(x), n, graph=tg)
    np.testing.assert_allclose(out_t.numpy(), expect, **TOL)
    plain = tapi.mh_spmm(tg.src, tg.dst, torch.from_numpy(w), torch.from_numpy(x), n)
    np.testing.assert_allclose(plain.numpy(), expect, **TOL)


@pytest.mark.parametrize("heads", [0, 3])
def test_segment_softmax_matches_jax(heads):
    """segment_softmax over dst-sorted and unsorted indices with empty
    segments, [nnz] and [nnz, H] logits, forward and gradient, against
    JAX's and against the plain segment_softmax_ref."""
    rng = np.random.default_rng(9 + heads)
    nnz, n_seg = 700, 200
    idx = np.sort(rng.integers(0, 150, nnz)).astype(np.int32)  # segments 150.. empty
    shape = (nnz,) if heads == 0 else (nnz, heads)
    logits = (3 * rng.standard_normal(shape)).astype(np.float32)
    cot = rng.standard_normal(shape).astype(np.float32)
    jf = lambda lg: japi.segment_softmax(lg, jnp.asarray(idx), n_seg)  # noqa: E731
    j = jf(jnp.asarray(logits))
    jg = jax.grad(lambda lg: jnp.vdot(jf(lg), jnp.asarray(cot)))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    t = tapi.segment_softmax(lt, torch.from_numpy(idx), n_seg)
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)
    torch.vdot(t.reshape(-1), torch.from_numpy(cot).reshape(-1)).backward()
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)
    r = tref.segment_softmax_ref(torch.from_numpy(logits), torch.from_numpy(idx), n_seg)
    np.testing.assert_allclose(r.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)
    perm = rng.permutation(nnz)
    u = tapi.segment_softmax(torch.from_numpy(logits[perm]), torch.from_numpy(idx[perm]),
                             n_seg, indices_are_sorted=False)
    np.testing.assert_allclose(u.numpy(), np.asarray(j)[perm], rtol=1e-5, atol=1e-6)


def _gat_pair(rng, n, e, **kw):
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    jg = jprepare_graph(src, dst, n, add_self_loops=True, **kw)
    tg = prepare_graph(src, dst, n, add_self_loops=True, layouts=("slot",), device="cpu",
                       **kw)
    return jg, tg


def _gat_inputs(rng, n, H, D):
    xh = rng.standard_normal((n, H, D)).astype(np.float32)
    a_s = (0.3 * rng.standard_normal((n, H))).astype(np.float32)
    a_d = (0.3 * rng.standard_normal((n, H))).astype(np.float32)
    co = rng.standard_normal((n, H, D)).astype(np.float32)
    return xh, a_s, a_d, co


def _t_gat(g, inputs, **kw):
    """The port's GAT aggregation: (output, the three gradients)."""
    xh, a_s, a_d, co = (torch.from_numpy(a) for a in inputs)
    args = [a.clone().requires_grad_() for a in (xh, a_s, a_d)]
    out = tapi.gat_attention_spmm(g, *args, **kw)
    torch.vdot(out.reshape(-1), co.reshape(-1)).backward()
    return out.detach().numpy(), [a.grad.numpy() for a in args]


def test_gat_attention_spmm_matches_edge_order():
    """Mirror of tests/test_ops.py::test_gat_attention_spmm_matches_edge_order:
    the fused slot-space route and the composed edge-space route (past
    fused_max_edges, through mh_spmm over the slot plans at H*D 32 too),
    forward and the three gradients, against JAX's edge-order composition
    and its fused route."""
    rng = np.random.default_rng(50)
    n, e, H, D = 70, 400, 4, 8
    jg, tg = _gat_pair(rng, n, e, e_tile=64, s_tile=128)
    inputs = _gat_inputs(rng, n, H, D)
    xh, a_s, a_d, co = (jnp.asarray(a) for a in inputs)

    def edge_order(xh, a_s, a_d):
        logits = jax.nn.leaky_relu(a_s[jg.src] + a_d[jg.dst], 0.2)
        att = japi.segment_softmax(logits, jg.dst, n)
        return jref.mh_spmm_ref(jg.src, jg.dst, att, xh, n)

    def fused(xh, a_s, a_d):
        return japi.gat_attention_spmm(jg, xh, a_s, a_d, backend="pallas")

    out_e = np.asarray(edge_order(xh, a_s, a_d))
    ge = jax.grad(lambda *a: jnp.vdot(edge_order(*a), co), argnums=(0, 1, 2))(xh, a_s, a_d)
    out_f = np.asarray(fused(xh, a_s, a_d))
    np.testing.assert_allclose(out_f, out_e, **TOL_GAT)
    for kw in ({}, {"fused_max_edges": 0}, {"backend": "reference"}):
        t, tgr = _t_gat(tg, inputs, **kw)
        np.testing.assert_allclose(t, out_e, **TOL_GAT, err_msg=str(kw))
        np.testing.assert_allclose(t, out_f, **TOL_GAT, err_msg=str(kw))
        for a, b in zip(ge, tgr):
            np.testing.assert_allclose(b, np.asarray(a), **TOL_GAT_GRAD, err_msg=str(kw))


def test_gat_pad_slots_weigh_zero():
    """Pad slots (and an empty window's all-pad tile) add exactly nothing
    on both routes, even where the node a pad names would overflow exp:
    the mh sum reads the attention in edge order and weighs every pad 0
    whatever edge it names, so a node with no in-edges aggregates exactly
    0. The reference's fused route multiplies its slot placement by the
    mask and gives NaN there (ROADMAP C.11)."""
    rng = np.random.default_rng(3)
    n, H, D = 300, 2, 4
    src = rng.integers(0, 100, 600).astype(np.int32)
    dst = rng.integers(0, 100, 600).astype(np.int32)  # nodes 100.. have no in-edges
    tg = prepare_graph(src, dst, n, add_self_loops=False, layouts=("slot",), e_tile=64,
                       s_tile=32, device="cpu")
    assert bool((tg.plan.mask == 0).any())
    xh = torch.from_numpy(rng.standard_normal((n, H, D)).astype(np.float32))
    a_s = torch.from_numpy(rng.standard_normal((n, H)).astype(np.float32))
    a_s[0] = 200.0  # pads gather node 0: exp(200 - m) overflows float32
    a_d = torch.zeros(n, H)
    ref = tapi.gat_attention_spmm(tg, xh, a_s, a_d, backend="reference")
    for kw in ({}, {"fused_max_edges": 0}):
        out = tapi.gat_attention_spmm(tg, xh, a_s, a_d, **kw)
        assert torch.isfinite(out).all()
        assert float(out[100:].abs().max()) == 0.0
        torch.testing.assert_close(out, ref, **TOL_GAT)
    jg = jprepare_graph(src, dst, n, add_self_loops=False, layouts=("slot",), e_tile=64,
                        s_tile=32)
    j = np.asarray(japi.gat_attention_spmm(jg, jnp.asarray(xh.numpy()), jnp.asarray(a_s.numpy()),
                                           jnp.asarray(a_d.numpy()), backend="reference"))
    assert not np.isfinite(j).all()
    finite = np.isfinite(j).all(axis=(1, 2))
    np.testing.assert_allclose(out.numpy()[finite], j[finite], **TOL_GAT)


def test_mh_and_gat_chunked_match_unchunked():
    """Mirror of tests/test_ops.py::test_mh_and_gat_chunked_match_unchunked:
    mh_spmm and the fused GAT route chunk by chunk (3 tiles a chunk) equal
    their single-shot results, forward and gradients; a uniformized
    chunked plan (pad tiles covering windows past n_blocks) too."""
    rng = np.random.default_rng(81)
    n, e, H, D = 120, 900, 4, 8
    jg, tg = _gat_pair(rng, n, e, e_tile=64, s_tile=64)
    ch = tplan.compute_chunks(tg.plan.out_block.numpy(), 3)
    assert len(ch) > 2
    tc = dataclasses.replace(
        tg, plan=dataclasses.replace(tg.plan, chunks=ch),
        plan_t=dataclasses.replace(
            tg.plan_t, chunks=tplan.compute_chunks(tg.plan_t.out_block.numpy(), 3)))
    src, dst = tg.src.numpy(), tg.dst.numpy()
    tu = tbuild_graph(src, dst, n, e_tile=64, s_tile=64, layouts=("slot",),
                      max_chunk_slots=64 * 5, assume_sorted=True, device="cpu")
    assert tu.plan.chunks and tu.plan.chunk_blocks
    w = rng.standard_normal((len(src), H)).astype(np.float32)
    inputs = _gat_inputs(rng, n, H, D)
    jo = japi.mh_spmm(jg.src, jg.dst, jnp.asarray(w), jnp.asarray(inputs[0]), n, graph=jg,
                      backend="pallas")
    jgat = japi.gat_attention_spmm(jg, *(jnp.asarray(a) for a in inputs[:3]),
                                   backend="pallas")
    base = _t_gat(tg, inputs)
    for g in (tc, tu):
        xt = torch.from_numpy(inputs[0]).requires_grad_()
        o = tapi.mh_spmm(g.src, g.dst, torch.from_numpy(w), xt, n, graph=g)
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), **TOL)
        o.square().sum().backward()
        xu = torch.from_numpy(inputs[0]).requires_grad_()
        tapi.mh_spmm(tg.src, tg.dst, torch.from_numpy(w), xu, n, graph=tg).square().sum(
        ).backward()
        np.testing.assert_allclose(xt.grad.numpy(), xu.grad.numpy(), rtol=1e-4, atol=1e-4)
        t, tgr = _t_gat(g, inputs)
        np.testing.assert_allclose(t, np.asarray(jgat), **TOL_GAT)
        for a, b in zip(base[1], tgr):
            np.testing.assert_allclose(b, a, **TOL_GAT_GRAD)
