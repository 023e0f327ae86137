"""The routes whose sums read x[src[e]] in the edge-row kernel since the
wide BAT sum (`bat_segment_sum`) and `plan_segment_sum_sr_packed` became
its callers, against `geot_tpu` `segment_spmm` (Pallas in interpret mode)
and its gradients at rtol/atol 2e-4 (the Pallas f32 kernels multiply
through a bf16 hi/lo split; tests/test_ops.py's bound):

- the BAT routes (`bat`, `bat_static`, `bat_dyn`) at widths 128, 100 and 47
  (no column padding), whole and chunked: one `bat_segment_sum` call with
  src over `bat` forward and one over `bat_t` for dx;
- the hybrid route's remainder, forward and dx: one call a direction;
- `index_scatter` over a BAT plan (edge-order values, the values form);
- the slot routes at F <= 64 (`slot`, `slot_static`, and the per-call
  GCN's dx over `plan_t` under `slot_dyn`), whole and chunked: one
  `plan_segment_sum_sr_packed` call with src a plan.

On the CPU the wrappers run their plain versions; the calls are counted on
`ops.api`'s names, which the card runs the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geot_tpu.graph.structures import build_graph as jbuild_graph
from geot_tpu.ops import api as japi
from geot_tpu_torch.graph.structures import build_graph as tbuild_graph
from geot_tpu_torch.ops import api as tapi

TOL = dict(rtol=2e-4, atol=2e-4)


def _hubby_sorted(rng, n, nnz, hub_edges, hub=7):
    dst = np.concatenate([np.full(hub_edges, hub, np.int32),
                          rng.integers(0, n, nnz).astype(np.int32)])
    src = rng.integers(0, n, len(dst)).astype(np.int32)
    order = np.argsort(dst, kind="stable")
    return src[order], dst[order]


def _record(monkeypatch, name):
    """Wrap ops.api's `name` to record whether each call passed src."""
    calls = []
    fn = getattr(tapi, name)

    def spy(*a, **kw):
        calls.append(kw.get("src") is not None)
        return fn(*a, **kw)

    monkeypatch.setattr(tapi, name, spy)
    return calls


def _check_route(jg, tg, x, w, cot, dyn):
    """segment_spmm forward, dx (and dw with per-call weights) of both
    packages on the same inputs."""
    def jop(xx, ww):
        return japi.segment_spmm(jg, xx, ww if dyn else None, backend="pallas")

    jout = jop(jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = jax.grad(lambda xx, ww: jnp.vdot(jop(xx, ww), jnp.asarray(cot)),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_(dyn)
    out = tapi.segment_spmm(tg, tx, edge_weight=tw if dyn else None)
    torch.vdot(out.reshape(-1), torch.from_numpy(cot).reshape(-1)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **TOL)
    if dyn:
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **TOL)


@pytest.mark.parametrize("path", ["bat", "bat_static", "bat_dyn"])
@pytest.mark.parametrize("n_feat", [128, 100, 47])
@pytest.mark.parametrize("chunked", [False, True])
def test_wide_bat_routes_vs_jax(monkeypatch, path, n_feat, chunked):
    """The wide BAT routes hand `bat_segment_sum` x and src at the layer's
    own width, once over `bat` and once over `bat_t` for dx, chunked (the
    hub window split) or not."""
    rng = np.random.default_rng(n_feat + len(path) + chunked)
    n = 160
    src, dst = _hubby_sorted(rng, n, 500, 600, hub=3)
    w_graph = (rng.random(len(dst)) + 0.1).astype(np.float32) if path == "bat_static" else None
    kw = dict(e_tile=64, s_tile=64, bat_e_tile=64, bat_s_tile=64, feature_hint=128)
    budget = 4 * 64 * 128 * 4 if chunked else 1 << 30
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOT_MAX_CHUNK_BYTES", str(budget))
        jg = jbuild_graph(src, dst, n, edge_weight=w_graph, layouts=("bat",), **kw)
    tg = tbuild_graph(src, dst, n, edge_weight=w_graph, max_chunk_bytes=budget,
                      layouts=("bat",), device="cpu", **kw)
    assert bool(tg.bat.chunks) == chunked and tg.bat.dst_km is None
    dyn = path == "bat_dyn"
    assert tapi.dispatch_path(tg, dynamic_w=dyn) == path
    calls = _record(monkeypatch, "bat_segment_sum")
    x = rng.standard_normal((n, n_feat)).astype(np.float32)
    w = rng.standard_normal(len(dst)).astype(np.float32)
    cot = rng.standard_normal((n, n_feat)).astype(np.float32)
    _check_route(jg, tg, x, w, cot, dyn)
    assert calls == [True, True]  # forward over bat, dx over bat_t


def _clustered(n, nnz_dense, nnz_uniform, seed):
    """Dense (window, block) cells of 1500 edges plus uniform noise, dst-
    sorted: a graph the stream census accepts, with a BAT remainder."""
    rng = np.random.default_rng(seed)
    n_w = n_b = max(n // 256, 1)
    n_cells = max(nnz_dense // 1500, 1)
    cw, cb = rng.integers(0, n_w, n_cells), rng.integers(0, n_b, n_cells)
    dst = (cw[:, None] * 256 + rng.integers(0, 256, (n_cells, 1500))).reshape(-1)
    src = (cb[:, None] * 256 + rng.integers(0, 256, (n_cells, 1500))).reshape(-1)
    dst = np.minimum(np.concatenate([dst, rng.integers(0, n, nnz_uniform)]), n - 1)
    src = np.minimum(np.concatenate([src, rng.integers(0, n, nnz_uniform)]), n - 1)
    order = np.argsort(dst, kind="stable")
    return src[order].astype(np.int32), dst[order].astype(np.int32)


@pytest.mark.parametrize("weighted,n_feat", [(False, 96), (True, 47)])
def test_hybrid_remainder_reads_x_in_kernel(monkeypatch, weighted, n_feat):
    """The hybrid route's BAT remainder hands `bat_segment_sum` x and its
    remainder src (no edge-order gather, no pad to 128), once forward and
    once for dx over `hyb_t`."""
    src, dst = _clustered(1200, 20_000, 2_000, seed=6)
    rng = np.random.default_rng(7)
    w = (rng.standard_normal(len(src)) ** 2 + 0.1).astype(np.float32) if weighted else None
    args = dict(e_tile=512, s_tile=256, bat_e_tile=1024, bat_s_tile=256, feature_hint=96,
                layouts=("bat", "stream"))
    jg = jbuild_graph(src, dst, 1200, edge_weight=w, **args)
    tg = tbuild_graph(src, dst, 1200, edge_weight=w, device="cpu", **args)
    assert tapi.dispatch_path(tg) == "hybrid" and tg.hyb.rest is not None
    assert {"hyb.rest", "hyb_t.rest"} <= set(tg.build_stats["row_schedule"])
    calls = _record(monkeypatch, "bat_segment_sum")
    x = rng.standard_normal((1200, n_feat)).astype(np.float32)
    cot = rng.standard_normal((1200, n_feat)).astype(np.float32)
    _check_route(jg, tg, x, np.ones(len(src), np.float32), cot, False)
    assert calls == [True, True]


@pytest.mark.parametrize("n_feat", [128, 40])
@pytest.mark.parametrize("chunked", [False, True])
def test_index_scatter_wide_bat_vs_jax(monkeypatch, n_feat, chunked):
    """index_scatter over an unpacked BAT plan: the edge-order rows go to
    `bat_segment_sum` whole, in one call (the values form), chunked or not;
    dvals = g[index]."""
    rng = np.random.default_rng(n_feat + chunked)
    # a hub of 200 edges: JAX's hi/lo bf16 split errs ~2^-16 of a row's
    # sum of |terms|, which a 500-edge hub of unweighted rows pushes to the
    # tolerance; the port is held to the float64 sum besides
    src, dst = _hubby_sorted(rng, 120, 400, 200, hub=2)
    kw = dict(bat_e_tile=64, bat_s_tile=32, feature_hint=128, layouts=("bat",))
    budget = 3 * 64 * 128 * 4 if chunked else 1 << 30
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GEOT_MAX_CHUNK_BYTES", str(budget))
        jg = jbuild_graph(src, dst, 120, **kw)
    tg = tbuild_graph(src, dst, 120, max_chunk_bytes=budget, device="cpu", **kw)
    assert bool(tg.bat.chunks) == chunked
    calls = _record(monkeypatch, "bat_segment_sum")
    v = rng.standard_normal((len(dst), n_feat)).astype(np.float32)
    cot = rng.standard_normal((120, n_feat)).astype(np.float32)
    j = japi.index_scatter(jnp.asarray(v), jnp.asarray(dst), 120, plan=jg.bat,
                           backend="pallas")
    tv = torch.from_numpy(v).requires_grad_()
    t = tapi.index_scatter(tv, torch.from_numpy(dst), 120, plan=tg.bat)
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)
    exp = np.zeros((120, n_feat))
    np.add.at(exp, dst, v.astype(np.float64))
    np.testing.assert_allclose(t.detach().numpy(), exp, **TOL)
    (t * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tv.grad.numpy(), cot[dst], rtol=0, atol=0)
    assert calls == [False]


@pytest.mark.parametrize("path", ["slot", "slot_static", "slot_dyn"])
@pytest.mark.parametrize("n_feat", [64, 40, 7])
@pytest.mark.parametrize("chunked", [False, True])
def test_slot_routes_read_x_in_kernel(monkeypatch, path, n_feat, chunked):
    """The slot routes at n <= 64 hand `plan_segment_sum_sr_packed` x and
    the plan's edge-order src, one call a plan, chunked or not: `slot` and
    `slot_static` forward over `plan` and dx over `plan_t`; `slot_dyn`'s
    forward is the AEB sum, its dx over `plan_t` (slot weights
    w[edge_pos_t]) the sr_packed call."""
    rng = np.random.default_rng(n_feat + len(path) + chunked)
    n = 200
    src, dst = _hubby_sorted(rng, n, 1200, 500, hub=5)
    w_graph = (rng.random(len(dst)) + 0.1).astype(np.float32) if path == "slot_static" else None
    kw = dict(e_tile=64, s_tile=64, bat_e_tile=64, bat_s_tile=32, feature_hint=64,
              layouts=("slot",))
    jg = jbuild_graph(src, dst, n, edge_weight=w_graph, **kw)
    tg = tbuild_graph(src, dst, n, edge_weight=w_graph, prefer="sr", prefer_dyn="sr",
                      device="cpu", max_chunk_slots=64 * 4 if chunked else 4 << 20, **kw)
    assert bool(tg.plan.chunks) == chunked
    dyn = path == "slot_dyn"
    assert tapi.dispatch_path(tg, dynamic_w=dyn) == path
    calls = _record(monkeypatch, "plan_segment_sum_sr_packed")
    x = rng.standard_normal((n, n_feat)).astype(np.float32)
    w = rng.standard_normal(len(dst)).astype(np.float32)
    cot = rng.standard_normal((n, n_feat)).astype(np.float32)
    _check_route(jg, tg, x, w, cot, dyn)
    assert calls == ([True] if dyn else [True, True])
