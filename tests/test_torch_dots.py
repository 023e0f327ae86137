"""The per-edge dot (`sddmm_bat`, `edge_dots`) and the transposed slot sum
(`plan_segment_sum_pr`) against the JAX package, in both forms each.

Inputs come from numpy with a seed and go through both packages; JAX runs
its Pallas kernels in interpret mode. Tolerances: the SDDMM at 1e-4, as
`tests/test_torch_grad.py` holds it (`test_sddmm_bat_kernel_matches_
reference`); the per-head dot, the reference's own XLA sum, at 1e-5; the
plain pr sum at 1e-4 * sum|terms| + 1e-5 per element (the Pallas f32
kernels multiply through a bf16 hi/lo split, as in
`tests/test_torch_slot.py`); the degree exactly; the routes' gradients as
`tests/test_torch_mh.py` (GAT: rtol 1e-3, atol 1e-4) and
`tests/test_torch_aeb.py` (slot_dyn: 2e-4) hold them.
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
from geot_tpu_torch.graph import plan as tplan
from geot_tpu_torch.graph.structures import build_graph as tbuild_graph
from geot_tpu_torch.models import prepare_graph
from geot_tpu_torch.ops import api as tapi
from geot_tpu_torch.ops import reference as tref
from geot_tpu_torch.ops.sddmm_kernels import edge_dots, edge_dots_plain, sddmm_bat_plain

TOL_SDDMM = dict(rtol=1e-4, atol=1e-4)
TOL_DOT = dict(rtol=1e-5, atol=1e-5)
TOL_GAT_GRAD = dict(rtol=1e-3, atol=1e-4)
TOL = dict(rtol=2e-4, atol=2e-4)
TILE = 64


def _hubby_sorted(rng, n, nnz, hub_edges, hub=7):
    dst = np.concatenate([np.full(hub_edges, hub, np.int32),
                          rng.integers(0, n, nnz).astype(np.int32)])
    src = rng.integers(0, n, len(dst)).astype(np.int32)
    order = np.argsort(dst, kind="stable")
    return src[order], dst[order]


def _bat_host_plan(dst, n, plan):
    """Host arrays of a BAT plan over dst: whole, or uniformized chunks one
    of whose pad tiles points past n_blocks."""
    if plan == "whole":
        return jplan.build_bat_plan_host(dst, n, e_tile=TILE, s_tile=TILE)
    for cap in range(3, 40):
        arrays, meta = jplan.build_bat_plan_host(dst, n, e_tile=TILE, s_tile=TILE,
                                                 max_chunk_tiles=cap)
        if meta["chunks"] and int(arrays["out_block"].max()) >= meta["n_blocks"]:
            return arrays, meta
    raise AssertionError("no chunk cap puts a pad tile past n_blocks")


@pytest.mark.parametrize("plan", ["whole", "chunked"])
@pytest.mark.parametrize("F", [128, 40])
def test_dot_plain_both_forms_vs_pallas(plan, F):
    """JAX's sddmm_bat in interpret mode (b gathered in edge order and
    zero-padded to whole value blocks, a padded to the plan's windows and
    128 lanes, as its caller does) against the port's plain versions in
    both forms over the same plan: sddmm_bat_plain with edge-order b and
    with b read as b[src[e]], and edge_dots_plain over the plan's dst ids
    (values and gathered)."""
    rng = np.random.default_rng(3 + F + (plan == "chunked"))
    n = 300
    src, dst = _hubby_sorted(rng, n, 2000, 600)
    arrays, meta = _bat_host_plan(dst, n, plan)
    jbp = jplan.bat_plan_from_host(arrays, meta)
    tbp = tplan.bat_plan_from_host(arrays, meta)
    nnz, E = len(dst), TILE
    a = rng.standard_normal((n, F)).astype(np.float32)
    b = rng.standard_normal((n, F)).astype(np.float32)
    rows_a = (meta["n_blocks"] + (meta["chunk_blocks"] if meta["chunks"] else 0)) * E
    a_p = np.zeros((rows_a, 128), np.float32)
    a_p[:n, :F] = a
    b_vals = np.zeros((meta["n_vblocks"] * E, 128), np.float32)
    b_vals[:nnz, :F] = b[src]
    j = np.asarray(jps.sddmm_bat(jbp, jnp.asarray(a_p), jnp.asarray(b_vals), interpret=True))
    ta, tb, ts = torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(src)
    values = sddmm_bat_plain(tbp, ta, torch.from_numpy(b[src]))
    gathered = sddmm_bat_plain(tbp, ta, tb, src=ts)
    assert values.shape == gathered.shape == j.shape == ((meta["n_vblocks"] + 1) * E,)
    np.testing.assert_allclose(values.numpy(), j, **TOL_SDDMM)
    np.testing.assert_allclose(gathered.numpy(), j, **TOL_SDDMM)
    d3 = tbp.dst3.reshape(-1)
    dv = edge_dots_plain(ta, torch.from_numpy(b[src]), d3)
    dg = edge_dots_plain(ta, tb, d3, ts)
    assert dv.shape == dg.shape == (j.shape[0], 1)
    np.testing.assert_allclose(dv.numpy()[:, 0], j, **TOL_SDDMM)
    np.testing.assert_allclose(dg.numpy()[:, 0], j, **TOL_SDDMM)
    assert (dg.numpy()[nnz:] == 0).all() and (gathered.numpy()[nnz:] == 0).all()


@pytest.mark.parametrize("H,D", [(4, 8), (4, 7), (1, 47)])
def test_dot_per_head_vs_reference(H, D):
    """The gathered per-head form against the reference's own dot of the
    multi-head weight gradient, jnp.sum(g[dst] * x[src], -1), on a
    dst-sorted edge list; rows past the end of the b side read zero."""
    rng = np.random.default_rng(H * 10 + D)
    n = 250
    src, dst = _hubby_sorted(rng, n, 1500, 400)
    g = rng.standard_normal((n, H, D)).astype(np.float32)
    x = rng.standard_normal((n, H, D)).astype(np.float32)
    want = np.asarray(jnp.sum(jnp.asarray(g)[dst] * jnp.asarray(x)[src], -1))
    got = edge_dots(torch.from_numpy(g.reshape(n, H * D)), torch.from_numpy(x.reshape(n, H * D)),
                    torch.from_numpy(dst), torch.from_numpy(src), D)
    assert got.shape == (len(dst), H)
    np.testing.assert_allclose(got.numpy(), want, **TOL_DOT)
    short = edge_dots_plain(torch.from_numpy(g.reshape(n, H * D)),
                            torch.from_numpy(x.reshape(n, H * D))[: n // 2],
                            torch.from_numpy(dst), torch.from_numpy(src), D)
    past = src >= n // 2
    assert (short.numpy()[past] == 0).all()
    np.testing.assert_allclose(short.numpy()[~past], want[~past], **TOL_DOT)


def _pr_plans(rng, chunked):
    """(JAX plan, port plan, src, n) over the same edges: slot tiles 64 x
    128 (the reference's pr rule: s_tile % 128 == 0), mode hint "pr";
    chunked: uniformized chunks with the hub window split."""
    n = 300
    src, dst = _hubby_sorted(rng, n, 1500, 500, hub=3)
    kw = dict(e_tile=64, s_tile=128, num_src_nodes=n,
              max_chunk_slots=64 * 4 if chunked else 4 << 20)
    jp = dataclasses.replace(jplan.build_segment_plan(dst, src, n + 100, **kw), mode_hint="pr")
    tp = tplan.build_segment_plan(dst, src, n + 100, **kw, device="cpu")
    assert bool(tp.chunks) == chunked
    if chunked:
        assert any(b[2] < a[3] for a, b in zip(tp.chunks[:-1], tp.chunks[1:]))
    return jp, tp, src, n


def _assert_abs_sum(t, j, a):
    bad = np.abs(t - j) > 1e-4 * a + 1e-5
    assert not bad.any(), (int(bad.sum()), float(np.abs(t - j).max()))


@pytest.mark.parametrize("F", [1, 8, 32])
@pytest.mark.parametrize("chunked", [False, True])
def test_pr_plain_both_forms_vs_pallas(F, chunked):
    """plan_segment_sum_pr's plain version in both forms (vals_t [F, T*E]
    in slot order; node rows x read as x[src[e]]) against JAX's pr kernel
    in interpret mode, with weights 0 on every third real slot of the hub
    row's run and on a tenth of the others (C.9): the whole plan directly,
    a chunked one through the reference's chunk loop (`_plan_sum`, mode
    pr), which the port sums whole."""
    rng = np.random.default_rng(F + 7 * chunked)
    jp, tp, src, n = _pr_plans(rng, chunked)
    T, E = tp.num_tiles, tp.e_tile
    mask = tp.mask.numpy()
    w = (mask * rng.standard_normal((T, E))).astype(np.float32)
    hub = (tp.dst_slots.numpy() == 3) & (mask > 0)
    k = np.arange(T * E).reshape(T, E)
    w[(hub & (k % 3 == 1)) | (~hub & (rng.random((T, E)) < 0.1))] = 0.0
    assert ((w == 0) & hub).any() and ((w != 0) & hub).sum() > 100
    x = rng.standard_normal((n, F)).astype(np.float32)
    vals = x[tp.src_slots.numpy().reshape(-1)]  # [T*E, F], pads read node 0 (weight 0)
    if chunked:
        j = np.asarray(japi._plan_sum(jp, jnp.asarray(vals), jnp.asarray(w)))
    else:
        j_t = jps.plan_segment_sum_pr(jp, jnp.asarray(np.ascontiguousarray(vals.T)),
                                      jnp.asarray(w), interpret=True)
        j = np.asarray(j_t)[:, : tp.num_segments].T
    tw = torch.from_numpy(w)
    vt = torch.from_numpy(np.ascontiguousarray(vals.T))
    values = tref.plan_segment_sum_pr_plain(tp, vt, tw)
    gathered = tref.plan_segment_sum_pr_plain(tp, torch.from_numpy(x), tw,
                                              src=torch.from_numpy(src))
    assert values.shape == gathered.shape == (F, tp.n_blocks * tp.s_tile)
    a = tref.plan_segment_sum_pr_plain(tp, vt.abs(), tw.abs()).numpy()[:, : tp.num_segments].T
    for got in (values, gathered):
        _assert_abs_sum(got.numpy()[:, : tp.num_segments].T, j, a)
    # the wrapper on CPU tensors is the plain version
    from geot_tpu_torch.ops.slot_kernels import plan_segment_sum_pr
    assert torch.equal(plan_segment_sum_pr(tp, vt, tw), values)


@pytest.mark.parametrize("chunked", [False, True])
def test_segment_counts_and_pr_route_vs_jax(chunked):
    """segment_counts over a slot plan (ones [1, slots], the plan whole)
    equals JAX's (ones [8, slots], chunk by chunk) and a bincount; the pr
    route of segment_spmm (x and src handed to the sum, no gather) and its
    x gradient equal JAX's at F 8."""
    rng = np.random.default_rng(11 + chunked)
    n = 300
    src, dst = _hubby_sorted(rng, n, 1500, 500, hub=3)
    kw = dict(e_tile=64, s_tile=128, bat_e_tile=64, bat_s_tile=32, feature_hint=128,
              layouts=("slot",))
    jg = jbuild_graph(src, dst, n, **kw)  # JAX's result does not depend on its chunks
    tg = tbuild_graph(src, dst, n, mode_hint="pr", device="cpu",
                      max_chunk_slots=64 * 4 if chunked else 4 << 20, **kw)
    jg = dataclasses.replace(jg, plan=dataclasses.replace(jg.plan, mode_hint="pr"),
                             plan_t=dataclasses.replace(jg.plan_t, mode_hint="pr"))
    assert bool(tg.plan.chunks) == chunked
    exp = np.bincount(dst, minlength=n).astype(np.float32)
    np.testing.assert_array_equal(tapi.segment_counts(tg.plan).numpy(), exp)
    np.testing.assert_array_equal(np.asarray(japi.segment_counts(jg.plan, backend="pallas")),
                                  exp)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    j, jvjp = jax.vjp(lambda xx: japi.segment_spmm(jg, xx, reduce="mean", backend="pallas"),
                      jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tapi.segment_spmm(tg, xt, reduce="mean")
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j), **TOL)
    out.backward(torch.from_numpy(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jvjp(jnp.asarray(x))[0]), **TOL)


def _counting(monkeypatch):
    """Counts the routes' calls of `edge_dots` (on the CPU it runs the plain
    version and counts no launch)."""
    calls = []

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return edge_dots(*args, **kw)

    monkeypatch.setattr(tapi, "edge_dots", counted)
    return calls


def test_gat_gradients_through_edge_dots(monkeypatch):
    """gat_attention_spmm's three gradients against JAX's (Pallas route):
    the attention's gradient is one edge_dots call per backward, per head
    over H*D columns."""
    rng = np.random.default_rng(50)
    n, e, H, D = 70, 400, 4, 7
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    jg = jprepare_graph(src, dst, n, add_self_loops=True, e_tile=64, s_tile=128)
    tg = prepare_graph(src, dst, n, add_self_loops=True, layouts=("slot",), device="cpu",
                       e_tile=64, s_tile=128)
    xh = rng.standard_normal((n, H, D)).astype(np.float32)
    a_s = (0.3 * rng.standard_normal((n, H))).astype(np.float32)
    a_d = (0.3 * rng.standard_normal((n, H))).astype(np.float32)
    co = rng.standard_normal((n, H, D)).astype(np.float32)
    jgr = jax.grad(lambda *a: jnp.vdot(japi.gat_attention_spmm(jg, *a, backend="pallas"),
                                       jnp.asarray(co)), argnums=(0, 1, 2))(
        jnp.asarray(xh), jnp.asarray(a_s), jnp.asarray(a_d))
    calls = _counting(monkeypatch)
    args = [torch.from_numpy(v).requires_grad_() for v in (xh, a_s, a_d)]
    out = tapi.gat_attention_spmm(tg, *args)
    assert not calls
    torch.vdot(out.reshape(-1), torch.from_numpy(co).reshape(-1)).backward()
    assert calls == [(n, H * D)]
    for t, j in zip(args, jgr):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), **TOL_GAT_GRAD)


@pytest.mark.parametrize("chunked", [False, True])
def test_slot_dyn_weight_gradient_through_edge_dots(chunked, monkeypatch):
    """slot_dyn's dw (gather_weight_scatter over slot plans with per-call
    weights) against jax.grad of JAX's Pallas path: one edge_dots call a
    backward, one head of F columns; dx and the forward unchanged."""
    rng = np.random.default_rng(8 + chunked)
    n, F = 300, 24
    src, dst = _hubby_sorted(rng, n, 2000, 400, hub=3)
    kw = dict(e_tile=64, s_tile=64, bat_e_tile=64, bat_s_tile=32, feature_hint=64,
              layouts=("slot",))
    jg = jbuild_graph(src, dst, n, **kw)
    tg = tbuild_graph(src, dst, n, prefer_dyn="sr", device="cpu",
                      max_chunk_slots=64 * 4 if chunked else 4 << 20, **kw)
    assert bool(tg.plan.chunks) == chunked
    assert tapi.dispatch_path(tg, dynamic_w=True) == "slot_dyn"
    x = rng.standard_normal((n, F)).astype(np.float32)
    w = rng.standard_normal(tg.num_edges).astype(np.float32)
    cot = rng.standard_normal((n, F)).astype(np.float32)

    def jloss(xx, ww):
        out = japi.gather_weight_scatter(jg.src, jg.dst, ww, xx, n, graph=jg, backend="pallas")
        return jnp.vdot(out, jnp.asarray(cot))

    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    calls = _counting(monkeypatch)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = tapi.gather_weight_scatter(tg.src, tg.dst, wt, xt, n, graph=tg)
    torch.vdot(out.reshape(-1), torch.from_numpy(cot).reshape(-1)).backward()
    assert calls == [(n, F)]
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), **TOL)
