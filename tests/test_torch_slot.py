"""The port's slot layout against the JAX package: plans, the three slot
kernels' plain versions, the slot routes of segment_spmm with their
gradients, and segment_counts (the models over slot graphs:
`test_torch_slot_models.py`).

Inputs come from numpy with a seed and go through both packages. JAX runs
its Pallas kernels in interpret mode. Tolerances: the plain kernels are
held to 1e-4 * sum|terms| + 1e-5 per element (the Pallas f32 kernels
multiply through a bf16 hi/lo split, about 2^-16 relative per term); the
fused ops to rtol/atol 2e-4 (the bound of tests/test_ops.py on the same
graph).
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
from geot_tpu_torch.graph.structures import build_graph as tbuild_graph
from geot_tpu_torch.ops import api as tapi
from geot_tpu_torch.ops import reference as tref

TOL = dict(rtol=2e-4, atol=2e-4)
ARRAY_KEYS = ("src_slots", "dst_slots", "edge_pos", "mask", "out_block", "e0")


def _zipf_edges(rng, n, nnz, hub_edges=0, hub=3, power=1.1):
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** -power
    p /= p.sum()
    dst = np.concatenate([rng.choice(n, size=nnz, p=p),
                          np.full(hub_edges, hub)]).astype(np.int32)
    src = rng.integers(0, n, size=len(dst), dtype=np.int32)
    return src, dst


PLAN_CASES = [
    # (n, nnz, hub_edges, extra_segments, e_tile, s_tile, pack_align, max_chunk_slots)
    (300, 2000, 0, 0, 64, 32, 1, 4 << 20),        # plain
    (300, 2000, 0, 0, 64, 32, 16, 4 << 20),       # pack-aligned windows (lead pads)
    (300, 2000, 900, 0, 64, 32, 16, 64 * 6),      # hub split across uniformized chunks
    (300, 2000, 900, 0, 32, 128, 1, 32 * 5),      # wide windows, chunked
    (200, 150, 0, 4000, 32, 32, 16, 4 << 20),     # many empty windows
    (200, 150, 0, 4000, 32, 32, 1, 32 * 7),       # empty windows + chunks
    (1000, 9000, 3000, 0, 96, 64, 16, 96 * 12),   # pack_align halved to 32 | 96
    (50, 0, 0, 0, 64, 32, 16, 4 << 20),           # no edges at all
]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_segment_plan_host_equal(case):
    """build_segment_plan_host: arrays and meta EQUAL to the reference's
    (the numpy path; the reference's native builder gives the same arrays,
    tests/test_native.py), and `_k_major_host` equal to the reference's
    k-major copies."""
    n, nnz, hub, extra, e_tile, s_tile, pack_align, mcs = case
    rng = np.random.default_rng(sum(case) % 2**32)
    src, dst = _zipf_edges(rng, n, nnz, hub)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    kw = dict(e_tile=e_tile, s_tile=s_tile, pack_align=pack_align, max_chunk_slots=mcs,
              num_src_nodes=n)
    ja, jm = jplan.build_segment_plan_host(dst, src, n + extra, **kw)
    ta, tm = tplan.build_segment_plan_host(dst, src, n + extra, **kw)
    assert set(ja) == set(ta) == set(ARRAY_KEYS)
    for k in ARRAY_KEYS:
        np.testing.assert_array_equal(ja[k], ta[k], err_msg=k)
        assert ja[k].dtype == ta[k].dtype, k
    assert jm == tm
    if mcs < 4096 and nnz:
        assert tm["chunks"] and tm["chunk_blocks"], "case meant to be chunked"
    jp = jplan.plan_from_host(ja, jm, km_pack=16)
    tp = tplan.plan_from_host(ta, tm)
    for k, a in (("dst_km", "dst_slots"), ("mask_km", "mask")):
        np.testing.assert_array_equal(np.asarray(getattr(jp, k)),
                                      tplan._k_major_host(ta[a], 16))
    assert jp.km_pack == 16 and tp.num_tiles == jp.num_tiles
    assert tp.num_tiles <= tplan.plan_tile_bounds(len(dst), n + extra, e_tile, s_tile) + (
        len(tm["chunks"]) * max((c[1] - c[0] for c in tm["chunks"]), default=0))


def test_segment_plan_rejects_bad_edges():
    with pytest.raises(ValueError):
        tplan.build_segment_plan_host(np.array([3, 1, 2]), None, 10)
    with pytest.raises(ValueError):
        tplan.build_segment_plan_host(np.array([1, 2, 12]), None, 10)


def _kernel_plan(rng, pack_align):
    n = 400
    src, dst = _zipf_edges(rng, n, 1500, 500)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    kw = dict(e_tile=64, s_tile=128, pack_align=pack_align, num_src_nodes=n)
    jp = jplan.build_segment_plan(dst, src, n + 100, **kw)
    tp = tplan.build_segment_plan(dst, src, n + 100, **kw, device="cpu")
    return jp, tp


def _assert_abs_sum(t, j, a):
    bad = np.abs(t - j) > 1e-4 * a + 1e-5
    assert not bad.any(), (int(bad.sum()), float(np.abs(t - j).max()))


@pytest.mark.parametrize("kernel,F", [("sr", 128), ("sr", 256), ("sr_packed", 8),
                                      ("sr_packed", 16), ("sr_packed", 32),
                                      ("sr_packed", 64), ("pr", 8), ("pr", 16)])
@pytest.mark.parametrize("pack_align", [1, 16])
def test_plain_kernels_match_pallas_interpret(kernel, F, pack_align):
    """Each plain kernel against its Pallas kernel in interpret mode, on
    the same plan, values and slot weights (pads weigh 0)."""
    rng = np.random.default_rng(F + pack_align)
    jp, tp = _kernel_plan(rng, pack_align)
    T, E = tp.num_tiles, tp.e_tile
    w = (tp.mask.numpy() * rng.standard_normal((T, E))).astype(np.float32)
    shape = (F, T * E) if kernel == "pr" else (T * E, F)
    v = rng.standard_normal(shape).astype(np.float32)
    if kernel == "sr":
        j = jps.plan_segment_sum_sr(jp, jnp.asarray(v), jnp.asarray(w),
                                    f_tile=_f_tile(F), interpret=True)
    elif kernel == "sr_packed":
        j = jps.plan_segment_sum_sr_packed(jp, jnp.asarray(v), jnp.asarray(w), interpret=True)
    else:
        j = jps.plan_segment_sum_pr(jp, jnp.asarray(v), jnp.asarray(w), interpret=True)
    plain = {"sr": tref.plan_segment_sum_sr_plain,
             "sr_packed": tref.plan_segment_sum_sr_packed_plain,
             "pr": tref.plan_segment_sum_pr_plain}[kernel]
    tv, tw = torch.from_numpy(v), torch.from_numpy(w)
    t = plain(tp, tv, tw).numpy()
    a = plain(tp, tv.abs(), tw.abs()).numpy()
    assert t.shape == np.asarray(j).shape
    _assert_abs_sum(t, np.asarray(j), a)


def _f_tile(n):
    return 256 if (n % 256 == 0 and n >= 256) else 128


def _graphs(weighted, s_tile=128, mode_hint="auto"):
    """(JAX graph, port graph) with slot plans only, same edges and tiles."""
    rng = np.random.default_rng(42)
    n = 300  # the graph of tests/test_ops.py: Zipf(1.0) in-degrees, a ~300-edge head
    src, dst = _zipf_edges(rng, n, 2000, power=1.0)
    w = rng.standard_normal(len(src)).astype(np.float32) if weighted else None
    kw = dict(e_tile=64, s_tile=s_tile, bat_e_tile=64, bat_s_tile=32, feature_hint=128)
    jg = jbuild_graph(src, dst, n, edge_weight=w, layouts=("slot",), **kw)
    tg = tbuild_graph(src, dst, n, edge_weight=w, layouts=("slot",), mode_hint=mode_hint,
                      device="cpu", **kw)
    if mode_hint != "auto":
        jg = dataclasses.replace(jg, plan=dataclasses.replace(jg.plan, mode_hint=mode_hint),
                                 plan_t=dataclasses.replace(jg.plan_t, mode_hint=mode_hint))
    return jg, tg, n


@pytest.mark.parametrize("n_feat", [1, 7, 16, 32, 64, 100, 128, 200])
@pytest.mark.parametrize("route", ["slot_static", "slot", "slot_mean"])
def test_segment_spmm_slot_routes_match_jax(route, n_feat):
    """segment_spmm on the slot routes, forward and x gradient, against
    JAX's segment_spmm(backend="pallas") and jax.grad over the same slot
    graph (the widths of tests/test_ops.py)."""
    jg, tg, n = _graphs(route == "slot_static")
    reduce = "mean" if route == "slot_mean" else "sum"
    assert tapi.dispatch_path(tg, reduce=reduce) == route.replace("_mean", "")
    assert japi.dispatch_path(jg, reduce=reduce, backend="pallas") == tapi.dispatch_path(tg)
    rng = np.random.default_rng(n_feat)
    x = rng.standard_normal((n, n_feat)).astype(np.float32)
    cot = rng.standard_normal((n, n_feat)).astype(np.float32)

    def jloss(xx):
        return jnp.vdot(japi.segment_spmm(jg, xx, reduce=reduce, backend="pallas"),
                        jnp.asarray(cot))

    jl, jdx = jax.value_and_grad(jloss)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tapi.segment_spmm(tg, xt, reduce=reduce)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(japi.segment_spmm(jg, jnp.asarray(x), reduce=reduce,
                                                            backend="pallas")), **TOL)
    torch.vdot(out.reshape(-1), torch.from_numpy(cot).reshape(-1)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), **TOL)


@pytest.mark.parametrize("n_feat", [8, 32])
def test_segment_spmm_pr_mode_matches_jax(n_feat):
    """mode_hint="pr" sends widths <= 128 through the pr kernel (edges on
    the contiguous axis), forward and backward, in both packages. (Past 64
    the reference pads its gather to odd multiples of 512 rows, which its
    pr kernel refuses when the slot count is a multiple of 1024: ROADMAP
    C.8; the port gathers exactly.)"""
    jg, tg, n = _graphs(True, mode_hint="pr")
    assert tapi._pick_mode(n_feat, tg.plan) == japi._pick_mode(n_feat, jg.plan) == "pr"
    x = np.random.default_rng(n_feat).standard_normal((n, n_feat)).astype(np.float32)
    j, jvjp = jax.vjp(lambda xx: japi.segment_spmm(jg, xx, backend="pallas"),
                      jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tapi.segment_spmm(tg, xt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j), **TOL)
    out.backward(torch.from_numpy(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jvjp(jnp.asarray(x))[0]), **TOL)


@pytest.mark.parametrize("s_tile", [128, 32])
def test_segment_counts_over_slot_plan(s_tile):
    """In-degrees from a slot plan: the pr kernel's path (s_tile % 128 ==
    0) and the scatter, equal to JAX's and to a bincount; a chunked plan
    (hub split across chunks) runs chunk by chunk to the same counts."""
    jg, tg, n = _graphs(False, s_tile=s_tile)
    exp = np.bincount(tg.dst.numpy(), minlength=n).astype(np.float32)
    np.testing.assert_array_equal(tapi.segment_counts(tg.plan).numpy(), exp)
    np.testing.assert_array_equal(
        np.asarray(japi.segment_counts(jg.plan, backend="pallas")), exp)
    tc = tbuild_graph(tg.src.numpy(), tg.dst.numpy(), n, e_tile=64, s_tile=s_tile,
                      layouts=("slot",), max_chunk_slots=64 * 4, assume_sorted=True,
                      device="cpu")
    assert tc.plan.chunks and any(b[2] < a[3] for a, b in zip(tc.plan.chunks[:-1],
                                                               tc.plan.chunks[1:]))
    np.testing.assert_array_equal(tapi.segment_counts(tc.plan).numpy(), exp)


def test_chunked_slot_spmm_matches_unchunked():
    """A slot plan cut into uniformized chunks (hub window split) sums, with
    its gradient, what the whole plan sums."""
    jg, tg, n = _graphs(True)
    tc = tbuild_graph(tg.src.numpy(), tg.dst.numpy(), n, tg.edge_weight.numpy(), e_tile=64,
                      s_tile=128, layouts=("slot",), max_chunk_slots=64 * 3,
                      assume_sorted=True, device="cpu")
    ch = tc.plan.chunks
    assert len(ch) > 2 and any(b[2] < a[3] for a, b in zip(ch[:-1], ch[1:]))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((n, 40)).astype(np.float32))
    outs = []
    for g in (tg, tc):
        xx = x.clone().requires_grad_()
        out = tapi.segment_spmm(g, xx)
        out.square().sum().backward()
        outs.append((out.detach(), xx.grad))
    # f32 sums of the same terms in two orders (the split hub row is added
    # chunk by chunk): the hub-row bound of tests/test_torch_gpu.py
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(outs[1][1], outs[0][1], rtol=1e-4, atol=1e-4)
