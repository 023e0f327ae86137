"""The port's GraphSAGE and GCN over slot graphs against the JAX package's
flax models: forward passes with the same weights, the dispatch between
the BAT and slot layouts, the SAGE weight tree, and the trainer.

Inputs come from numpy with a seed and go through both packages; JAX runs
its Pallas kernels in interpret mode. Tolerances: models rtol/atol 2e-4
(the bf16 hi/lo split of the Pallas f32 kernels, sums of up to a few
hundred terms of magnitude ~1); the trainer, whose JAX side runs its f32
reference backend, 1e-5 as `test_torch_train.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geot_tpu.graph.structures import build_graph as jbuild_graph
from geot_tpu.models import GCN as JGCN
from geot_tpu.models import GraphSAGE as JGraphSAGE
from geot_tpu.models import prepare_graph as jprepare_graph
from geot_tpu.models import train as jtrain
from geot_tpu.ops import api as japi
from geot_tpu_torch.graph.structures import build_graph as tbuild_graph
from geot_tpu_torch.models import (
    GCN,
    MODELS,
    GraphSAGE,
    load_checkpoint,
    make_optimizer,
    make_train_step,
    params_from_flax,
    params_to_flax,
    prepare_graph,
    save_checkpoint,
)
from geot_tpu_torch.ops import api as tapi

TOL = dict(rtol=2e-4, atol=2e-4)
TOL_F32 = dict(rtol=1e-5, atol=1e-5)


def _zipf_edges(rng, n, nnz, hub_edges=0, hub=3, power=1.1):
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** -power
    p /= p.sum()
    dst = np.concatenate([rng.choice(n, size=nnz, p=p),
                          np.full(hub_edges, hub)]).astype(np.int32)
    src = rng.integers(0, n, size=len(dst), dtype=np.int32)
    return src, dst


def _np(params):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("layouts", [("slot",), ("bat", "slot")])
@pytest.mark.parametrize("prefer,prefer_dyn", [("bat", "bat"), ("sr", "bat"), ("sr", "sr")])
def test_dispatch_path_matches_jax(weighted, layouts, prefer, prefer_dyn):
    """The route for graph/no weights and for per-call weights, given the
    same plans and layout preferences, is the reference's (slot_dyn
    included)."""
    rng = np.random.default_rng(1)
    src, dst = _zipf_edges(rng, 100, 600)
    w = rng.random(len(src)).astype(np.float32) if weighted else None
    kw = dict(e_tile=64, s_tile=32, bat_e_tile=64, bat_s_tile=32)
    jg = dataclasses.replace(jbuild_graph(src, dst, 100, edge_weight=w, layouts=layouts, **kw),
                             prefer=prefer, prefer_dyn=prefer_dyn)
    tg = tbuild_graph(src, dst, 100, edge_weight=w, layouts=layouts, prefer=prefer,
                      prefer_dyn=prefer_dyn, device="cpu", **kw)
    for reduce in ("sum", "mean"):
        assert tapi.dispatch_path(tg, reduce=reduce) == japi.dispatch_path(
            jg, reduce=reduce, backend="pallas")
    assert tapi.dispatch_path(tg, dynamic_w=True) == japi.dispatch_path(
        jg, dynamic_w=True, backend="pallas")


def _sage_pair(rng, n=300, nnz=2400):
    src, dst = _zipf_edges(rng, n, nnz, 400)
    kw = dict(e_tile=64, s_tile=128, feature_hint=128, layouts=("slot",))
    jg = jprepare_graph(src, dst, n, add_self_loops=False, **kw)
    tg = prepare_graph(src, dst, n, add_self_loops=False, mode_hint="sr", prefer="sr",
                       device="cpu", **kw)
    assert tapi.dispatch_path(tg, reduce="mean") == "slot"
    return jg, tg, src, dst


@pytest.mark.parametrize("normalize", [False, True])
def test_graphsage_matches_flax(normalize):
    """GraphSAGE (mean aggregation, lin_l with bias, lin_r on the root,
    optional L2 row norm) over a slot graph, with the flax weights carried
    by params_from_flax; the weight tree round-trips."""
    rng = np.random.default_rng(21 + normalize)
    jg, tg, _, _ = _sage_pair(rng)
    x = rng.standard_normal((300, 24)).astype(np.float32)
    ck = {"normalize": normalize}
    jm = JGraphSAGE(hidden_features=32, num_layers=3, out_features=7, backend="pallas",
                    conv_kwargs=ck)
    params = jm.init(jax.random.PRNGKey(5), jnp.asarray(x), jg)
    j = jm.apply(params, jnp.asarray(x), jg)
    tm = GraphSAGE(24, 32, 3, 7, conv_kwargs=ck, device="cpu").eval()
    tm.load_state_dict(params_from_flax(_np(params)))
    with torch.inference_mode():
        t = tm(torch.from_numpy(x), tg)
    assert t.shape == (300, 7) and torch.isfinite(t).all()
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    back = params_to_flax(tm.state_dict())
    flat_j = jax.tree_util.tree_leaves_with_path(_np(params))
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_j, flat_b):
        np.testing.assert_array_equal(a, b)


def test_sage_weights_layout_and_init():
    rng = np.random.default_rng(0)
    params = {"params": {f"SAGEConv_{i}": {
        "Dense_0": {"kernel": rng.standard_normal((a, b)).astype(np.float32),
                    "bias": rng.standard_normal(b).astype(np.float32)},
        "Dense_1": {"kernel": rng.standard_normal((a, b)).astype(np.float32)}}
        for i, (a, b) in enumerate([(6, 4), (4, 3)])}}
    m = GraphSAGE(6, 4, 2, 3, device="cpu")
    m.load_state_dict(params_from_flax(params))  # strict
    np.testing.assert_array_equal(m.convs[1].lin_r.weight.detach().numpy(),
                                  params["params"]["SAGEConv_1"]["Dense_1"]["kernel"].T)
    with pytest.raises(ValueError):
        params_from_flax({"SAGEConv_0": {"Dense_2": {"kernel": np.zeros((2, 2))}}})
    # flax nn.Dense's init: lecun normal kernels (truncated at 2 std), zero bias
    a = GraphSAGE(400, 300, 2, 4, generator=torch.Generator().manual_seed(1), device="cpu")
    b = GraphSAGE(400, 300, 2, 4, generator=torch.Generator().manual_seed(1), device="cpu")
    for pa, pb in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    wl = a.convs[0].lin_l.weight
    assert abs(float(wl.detach().std()) * 400 ** 0.5 - 1.0) < 0.05
    assert float(wl.detach().abs().max()) <= 2 / 0.87962566103423978 / 400 ** 0.5 + 1e-6
    assert float(a.convs[0].lin_l.bias.detach().abs().max()) == 0.0
    assert MODELS["graphsage"] == (GraphSAGE, False) and MODELS["gcn"] == (GCN, True)


def test_gcn_default_layouts_match_jax():
    """prepare_graph(normalize="gcn") with the default layouts ("bat",
    "slot") bakes the norm into slot weights, and GCN() with its default
    conv kwargs takes it as it is: no second normalization, as in the
    reference (ROADMAP C.1). Both on bat_static (prefer "bat", the
    reference's answer for explicit tiles) and on slot_static (prefer
    "sr")."""
    rng = np.random.default_rng(31)
    n = 300
    src, dst = _zipf_edges(rng, n, 2400)
    kw = dict(e_tile=64, s_tile=32, feature_hint=128)
    jg = jprepare_graph(src, dst, n, normalize="gcn", **kw)
    assert jg.w_slots is not None
    x = rng.standard_normal((n, 16)).astype(np.float32)
    jm = JGCN(hidden_features=32, num_layers=3, out_features=5, backend="pallas")
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x), jg)
    j = jm.apply(params, jnp.asarray(x), jg)
    for prefer, route in (("bat", "bat_static"), ("sr", "slot_static")):
        tg = prepare_graph(src, dst, n, normalize="gcn", bat_e_tile=64, bat_s_tile=32,
                           prefer=prefer, device="cpu", **kw)
        assert tg.w_slots is not None and tg.bat is not None
        assert tapi.dispatch_path(tg) == route
        tm = GCN(16, 32, 3, 5, device="cpu").eval()
        assert all(c.normalize for c in tm.convs)
        tm.load_state_dict(params_from_flax(_np(params)))
        with torch.inference_mode():
            t = tm(torch.from_numpy(x), tg)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def _cells(n, nnz_dense, nnz_uniform, seed=0, s_tile=256, epc=1500):
    """Dense (window, block) cells of `epc` edges plus uniform noise,
    dst-sorted: a graph the stream census takes."""
    rng = np.random.default_rng(seed)
    n_w = max(n // s_tile, 1)
    cells = max(nnz_dense // epc, 1)
    cw, cb = rng.integers(0, n_w, cells), rng.integers(0, n_w, cells)
    dst = (cw[:, None] * s_tile + rng.integers(0, s_tile, (cells, epc))).reshape(-1)
    src = (cb[:, None] * s_tile + rng.integers(0, s_tile, (cells, epc))).reshape(-1)
    dst = np.minimum(np.concatenate([dst, rng.integers(0, n, nnz_uniform)]), n - 1)
    src = np.minimum(np.concatenate([src, rng.integers(0, n, nnz_uniform)]), n - 1)
    order = np.argsort(dst, kind="stable")
    return src[order].astype(np.int32), dst[order].astype(np.int32)


def test_build_graph_default_layouts_match_jax():
    """build_graph's default layouts are the reference's ("bat", "slot",
    "stream"; ROADMAP C.13): the same graph built with both packages'
    defaults (tiles given, so the reference reads no tuning table) has the
    same plan families, dispatch_path agrees for graph weights, no weights
    and per-call weights, and mh_spmm(graph=...) and gat_attention_spmm run
    on the default graph and match JAX (tests/test_torch_mh.py's
    tolerances). Where the stream census refuses both directions the
    hybrid family is absent from both, and the other two are checked."""
    from geot_tpu.ops import reference as jref

    n = 1200
    src, dst = _cells(n, 20_000, 2_000)
    rng = np.random.default_rng(3)
    w = (rng.random(len(src)) + 0.1).astype(np.float32)
    kw = dict(e_tile=512, s_tile=256, bat_e_tile=1024, bat_s_tile=256)
    for weight in (None, w):
        jg = jbuild_graph(src, dst, n, edge_weight=weight, **kw)
        tg = tbuild_graph(src, dst, n, edge_weight=weight, device="cpu", **kw)
        for fam in ("bat", "bat_t", "plan", "plan_t", "hyb", "hyb_t"):
            assert (getattr(tg, fam) is None) == (getattr(jg, fam) is None), fam
        assert tg.plan is not None and tg.bat is not None
        for dyn in (False, True):
            assert tapi.dispatch_path(tg, dynamic_w=dyn) == japi.dispatch_path(
                jg, dynamic_w=dyn, backend="pallas"), (weight is None, dyn)
    assert tg.hyb is not None, "the census took this graph in both packages"
    H, D = 2, 8
    wh = rng.standard_normal((len(src), H)).astype(np.float32)
    x = rng.standard_normal((n, H, D)).astype(np.float32)
    jo = japi.mh_spmm(jg.src, jg.dst, jnp.asarray(wh), jnp.asarray(x), n, graph=jg,
                      backend="pallas")
    to = tapi.mh_spmm(tg.src, tg.dst, torch.from_numpy(wh), torch.from_numpy(x), n, graph=tg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        to.numpy(), np.asarray(jref.mh_spmm_ref(jg.src, jg.dst, jnp.asarray(wh),
                                                jnp.asarray(x), n)), rtol=2e-4, atol=2e-4)
    a_s = (0.3 * rng.standard_normal((n, H))).astype(np.float32)
    a_d = (0.3 * rng.standard_normal((n, H))).astype(np.float32)
    jgat = japi.gat_attention_spmm(jg, jnp.asarray(x), jnp.asarray(a_s), jnp.asarray(a_d),
                                   backend="pallas")
    tgat = tapi.gat_attention_spmm(tg, torch.from_numpy(x), torch.from_numpy(a_s),
                                   torch.from_numpy(a_d))
    np.testing.assert_allclose(tgat.numpy(), np.asarray(jgat), rtol=1e-4, atol=1e-4)


def test_graphsage_train_lockstep_with_jax(tmp_path):
    """3 AdamW steps of GraphSAGE over a slot graph beside optax's adamw on
    the JAX model (its f32 reference backend); then a checkpoint round
    trip of the SAGE tree through the reference's format."""
    from geot_tpu.graph.datasets import synthetic_classification_graph

    d = synthetic_classification_graph(200, 1200, 4, seed=6, feature_noise=0.4)
    x = d.x.astype(np.float32)
    kw = dict(e_tile=64, s_tile=128, feature_hint=128, layouts=("slot",))
    jg = jprepare_graph(d.src, d.dst, 200, add_self_loops=False, **kw)
    tg = prepare_graph(d.src, d.dst, 200, add_self_loops=False, prefer="sr", device="cpu",
                       **kw)
    jm = JGraphSAGE(hidden_features=16, num_layers=3, out_features=4, backend="reference")
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jg)
    tx = optax.adamw(0.01, weight_decay=5e-4)
    opt_state = tx.init(params)
    jstep = jtrain.make_train_step(jm, tx, has_dropout=False)
    tm = GraphSAGE(x.shape[1], 16, 3, 4, device="cpu")
    tm.load_state_dict(params_from_flax(_np(params)))
    tstep = make_train_step(tm, make_optimizer(tm, 0.01, 5e-4), has_dropout=False)
    xt, yt = torch.from_numpy(x), torch.from_numpy(d.y.astype(np.int64))
    mt = torch.from_numpy(d.train_mask)
    rng = jax.random.PRNGKey(1)
    for _ in range(3):
        params, opt_state, rng, jl = jstep(params, opt_state, rng, jnp.asarray(x), jg,
                                           jnp.asarray(d.y), jnp.asarray(d.train_mask))
        tl = tstep(xt, tg, yt, mt)
        np.testing.assert_allclose(float(tl), float(jl), **TOL_F32)
    want = params_from_flax(_np(params))
    got = tm.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **TOL_F32, err_msg=k)
    ckpt = str(tmp_path / "sage.npz")
    save_checkpoint(ckpt, got, {"steps": 3})
    restored, meta = load_checkpoint(ckpt)
    assert meta == {"steps": 3}
    for k, v in got.items():
        torch.testing.assert_close(restored[k], v, rtol=0, atol=0)
    jrestored, _ = jtrain.load_checkpoint(ckpt)
    np.testing.assert_array_equal(
        np.asarray(jrestored["params"]["SAGEConv_0"]["Dense_1"]["kernel"]),
        got["convs.0.lin_r.weight"].numpy().T)
