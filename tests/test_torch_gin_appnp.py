"""The port's GIN, SGC and APPNP (with MLP, GINConv, SGConv and APPNPConv)
against the JAX package's flax models, over packed narrow-feature BAT
plans: forward passes and gradients with the same weights (carried by
`params_from_flax`), the weight trees, and the trainer.

Inputs come from numpy with a seed and go through both packages; JAX runs
its Pallas kernels in interpret mode. Tolerances: models and their
gradients rtol/atol 2e-4 (the bf16 hi/lo split of the Pallas f32 kernels,
sums of up to a few hundred terms of magnitude ~1; gradients atol 2e-4 *
max|g|); the trainer, whose JAX side runs its f32 reference backend: the
losses 1e-5 as `test_torch_train.py`, the first step's gradients 1e-5 *
max|g|, and the parameters after 3 steps 1e-5 relative with 1e-4 absolute
(1% of one step at lr 0.01): AdamW divides each gradient element by its
root mean square, so where an element is near 0 its float32 rounding
(GIN's unnormalized sums give gradients of ~20, rounded at ~2e-6) moves
that element's step by a fraction of lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geot_tpu.models import MODELS as JMODELS
from geot_tpu.models import APPNPConv as JAPPNPConv
from geot_tpu.models import GINConv as JGINConv
from geot_tpu.models import SGConv as JSGConv
from geot_tpu.graph.structures import build_graph as jbuild_graph
from geot_tpu.models import train as jtrain
from geot_tpu_torch.models import (
    APPNP,
    GIN,
    MLP,
    MODELS,
    SGC,
    APPNPConv,
    GINConv,
    SGConv,
    load_checkpoint,
    make_optimizer,
    make_train_step,
    params_from_flax,
    params_to_flax,
    save_checkpoint,
)
from geot_tpu_torch.graph.structures import build_graph as tbuild_graph
from geot_tpu_torch.ops import api as tapi

TOL = dict(rtol=2e-4, atol=2e-4)
TOL_F32 = dict(rtol=1e-5, atol=1e-5)
TOL_ADAM = dict(rtol=1e-5, atol=1e-4)
TILES = dict(e_tile=64, s_tile=32, bat_e_tile=64, bat_s_tile=32)


def _zipf_edges(rng, n, nnz, hub_edges=0, hub=3, power=1.1):
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** -power
    p /= p.sum()
    dst = np.concatenate([rng.choice(n, size=nnz, p=p),
                          np.full(hub_edges, hub)]).astype(np.int32)
    src = rng.integers(0, n, size=len(dst), dtype=np.int32)
    return src, dst


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _graphs(src, dst, n, feature_hint, loops, normalize=None):
    """(JAX graph, port graph) with BAT plans only, packed for
    `feature_hint`, over the edges with self-loops (`loops`) and the GCN
    norm baked in (`normalize="gcn"`) as both packages' `prepare_graph`
    would make them. Every tile is given, so the JAX builder asks its
    tuning table nothing (its `prepare_graph` leaves the BAT tiles to it)."""
    src, dst, w = np.asarray(src, np.int32), np.asarray(dst, np.int32), None
    if loops:
        keep = src != dst
        loop = np.arange(n, dtype=np.int32)
        src, dst = np.concatenate([src[keep], loop]), np.concatenate([dst[keep], loop])
    if normalize == "gcn":
        deg = np.bincount(dst, minlength=n).astype(np.float32)
        dinv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
        w = (dinv[dst] * dinv[src]).astype(np.float32)
    kw = dict(edge_weight=w, feature_hint=feature_hint, layouts=("bat",), **TILES)
    jg = jbuild_graph(src, dst, n, **kw)
    tg = tbuild_graph(src, dst, n, device="cpu", **kw)
    assert tg.bat.km_pack == jg.bat.km_pack > 1
    return jg, tg


def _pair(rng, feature_hint, loops, normalize=None, n=240, nnz=1800, hub_edges=300):
    src, dst = _zipf_edges(rng, n, nnz, hub_edges)
    return _graphs(src, dst, n, feature_hint, loops, normalize) + (n,)


def _check_grads(tmod, jgrads):
    """Each port parameter's gradient against the flax gradient of the same
    leaf (through params_from_flax)."""
    want = params_from_flax(_np(jgrads))
    got = dict(tmod.named_parameters())
    assert set(got) == set(want)
    for k, g in want.items():
        np.testing.assert_allclose(got[k].grad.numpy(), g.numpy(), rtol=TOL["rtol"],
                                   atol=TOL["atol"] * max(float(g.abs().max()), 1.0),
                                   err_msg=k)


def _run_both(jmod, params, tmod, jg, tg, x, cot):
    """Forward of both; then the gradient of <out, cot> for every parameter
    and for x. Returns (port out, JAX out, port dx, JAX dx, JAX param
    grads)."""
    j = jmod.apply(params, jnp.asarray(x), jg)
    jgp, jdx = jax.grad(lambda p, xx: jnp.vdot(jmod.apply(p, xx, jg), jnp.asarray(cot)),
                        argnums=(0, 1))(params, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    t = tmod(tx, tg)
    torch.vdot(t.reshape(-1), torch.from_numpy(cot).reshape(-1)).backward()
    return t.detach(), np.asarray(j), tx.grad, np.asarray(jdx), jgp


@pytest.mark.parametrize("train_eps", [False, True])
@pytest.mark.parametrize("in_feat", [12, 40])
def test_ginconv_matches_flax(train_eps, in_feat):
    """GINConv (eps 0.3) over a packed graph without self-loops, forward and
    gradients (eps included when trained); the MLP is flax's MLP_0."""
    rng = np.random.default_rng(2 + train_eps + in_feat)
    jg, tg, n = _pair(rng, in_feat, loops=False)
    assert tapi.dispatch_path(tg) == "bat"
    x = rng.standard_normal((n, in_feat)).astype(np.float32)
    cot = rng.standard_normal((n, 8)).astype(np.float32)
    jc = JGINConv(features=8, eps=0.3, train_eps=train_eps, backend="pallas")
    params = jc.init(jax.random.PRNGKey(0), jnp.asarray(x), jg)
    tc = GINConv(in_feat, 8, eps=0.3, train_eps=train_eps, device="cpu")
    state = params_from_flax({"GINConv_0": _np(params)["params"]})
    tc.load_state_dict({k.split(".", 2)[2]: v for k, v in state.items()})
    t, j, tdx, jdx, jgp = _run_both(jc, params, tc, jg, tg, x, cot)
    assert t.shape == (n, 8)
    np.testing.assert_allclose(t.numpy(), j, **TOL)
    np.testing.assert_allclose(tdx.numpy(), jdx, **TOL)
    want = params_from_flax({"GINConv_0": _np(jgp)["params"]})
    for k, g in want.items():
        p = dict(tc.named_parameters())[k.split(".", 2)[2]]
        np.testing.assert_allclose(p.grad.numpy(), g.numpy(), rtol=TOL["rtol"],
                                   atol=TOL["atol"] * max(float(g.abs().max()), 1.0),
                                   err_msg=k)
    assert isinstance(tc.mlp, MLP) and len(tc.mlp.lins) == 2
    assert (tc.eps is not None) == train_eps


@pytest.mark.parametrize("conv", ["sgconv", "appnpconv"])
@pytest.mark.parametrize("normalize", [None, "gcn"])
def test_sgconv_appnpconv_match_flax(conv, normalize):
    """SGConv (k 2) and APPNPConv (k 3, alpha 0.2) over a packed graph with
    self-loops and no slot weights: the norm is a per-call weight
    (bat_dyn). normalize="gcn" bakes the norm into the graph's weights,
    which both packages then normalize a second time (ROADMAP C.1,
    reproduced)."""
    rng = np.random.default_rng(4 + len(conv) + (normalize is not None))
    width = 10 if conv == "sgconv" else 7
    jg, tg, n = _pair(rng, width, loops=True, normalize=normalize)
    assert tg.w_slots is None and tapi.dispatch_path(tg, dynamic_w=True) == "bat_dyn"
    x = rng.standard_normal((n, width)).astype(np.float32)
    if conv == "sgconv":
        jc, tc = JSGConv(features=5, k=2, backend="pallas"), SGConv(width, 5, k=2, device="cpu")
        out_w = 5
    else:
        jc = JAPPNPConv(k=3, alpha=0.2, backend="pallas")
        tc = APPNPConv(k=3, alpha=0.2)
        out_w = width
    params = jc.init(jax.random.PRNGKey(1), jnp.asarray(x), jg)
    if conv == "sgconv":
        state = params_from_flax({"SGConv_0": _np(params)["params"]})
        tc.load_state_dict({k.split(".", 2)[2]: v for k, v in state.items()})
    else:
        assert not _np(params).get("params") and not list(tc.parameters())
    cot = rng.standard_normal((n, out_w)).astype(np.float32)
    t, j, tdx, jdx, _ = _run_both(jc, params, tc, jg, tg, x, cot)
    assert t.shape == (n, out_w)
    np.testing.assert_allclose(t.numpy(), j, **TOL)
    np.testing.assert_allclose(tdx.numpy(), jdx, **TOL)


def _models(name, in_feat, hidden, out, seed=0):
    """The flax model and the port's, the port's built by its MODELS
    entry."""
    jcls, jloops = JMODELS[name]
    tcls, tloops = MODELS[name]
    assert jloops == tloops
    kw = dict(k=4) if name == "appnp" else {}
    jm = jcls(hidden_features=hidden, num_layers=3 if name != "sgc" else 2, out_features=out,
              backend="pallas", **kw)
    tm = tcls(in_feat, hidden, 3 if name != "sgc" else 2, out, device="cpu", **kw)
    return jm, tm, tloops


@pytest.mark.parametrize("name", ["gin", "sgc", "appnp"])
def test_models_match_flax(name):
    """GIN (packed hidden layers), SGC (k = num_layers) and APPNP (MLP then
    4 propagations at the class width) against the flax models: forward,
    the input gradient and every parameter's gradient; the weight tree
    round-trips."""
    rng = np.random.default_rng(11 + len(name))
    in_feat, hidden, out = 24, 32, 7
    jm, tm, loops = _models(name, in_feat, hidden, out)
    fh = {"gin": hidden, "sgc": in_feat, "appnp": out}[name]
    jg, tg, n = _pair(rng, fh, loops=loops)
    x = rng.standard_normal((n, in_feat)).astype(np.float32)
    cot = rng.standard_normal((n, out)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x), jg)
    tm.load_state_dict(params_from_flax(_np(params)))  # strict
    tm.eval()
    t, j, tdx, jdx, jgp = _run_both(jm, params, tm, jg, tg, x, cot)
    assert t.shape == (n, out) and torch.isfinite(t).all()
    np.testing.assert_allclose(t.numpy(), j, **TOL)
    np.testing.assert_allclose(tdx.numpy(), jdx, **TOL)
    _check_grads(tm, jgp)
    back = params_to_flax(tm.state_dict())
    flat_j = jax.tree_util.tree_leaves_with_path(_np(params))
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_j, flat_b):
        np.testing.assert_array_equal(a, b)


def test_weight_trees_and_init():
    """The GIN (trained eps), SGC and APPNP trees map both ways; malformed
    trees are refused; the Dense layers draw as flax's nn.Dense does."""
    rng = np.random.default_rng(0)

    def dense(a, b):
        return {"kernel": rng.standard_normal((a, b)).astype(np.float32),
                "bias": rng.standard_normal(b).astype(np.float32)}

    gin = {"params": {f"GINConv_{i}": {"MLP_0": {"Dense_0": dense(a, b), "Dense_1": dense(b, b)},
                                       "eps": np.float32(0.1 * i)}
                      for i, (a, b) in enumerate([(6, 4), (4, 3)])}}
    m = GIN(6, 4, 2, 3, conv_kwargs={"train_eps": True}, device="cpu")
    m.load_state_dict(params_from_flax(gin))  # strict
    np.testing.assert_array_equal(m.convs[1].mlp.lins[1].weight.detach().numpy(),
                                  gin["params"]["GINConv_1"]["MLP_0"]["Dense_1"]["kernel"].T)
    assert float(m.convs[1].eps.detach()) == np.float32(0.1)
    appnp = {"params": {"Dense_0": dense(6, 4), "Dense_1": dense(4, 3)}}
    a = APPNP(6, 4, 2, 3, device="cpu")
    a.load_state_dict(params_from_flax(appnp))
    sgc = {"params": {"SGConv_0": {"Dense_0": dense(6, 3)}}}
    s = SGC(6, 4, 2, 3, device="cpu")
    s.load_state_dict(params_from_flax(sgc))
    for tree, mod in ((gin, m), (appnp, a), (sgc, s)):
        back = params_to_flax(mod.state_dict())
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
        for x, y in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(x, y)
    for bad in ({"GINConv_0": {"MLP_0": {"Dense_0": {"kernel": np.zeros((2, 2))}}}},
                {"GINConv_0": {"MLP_0": {}, "scale": np.zeros(())}},
                {"SGConv_0": {"Dense_1": dense(2, 2)}},
                {"Dense_0": {"kernel": np.zeros((2, 2))}},
                {"APPNPConv_0": {"alpha": np.zeros(())}}):
        with pytest.raises(ValueError):
            params_from_flax(bad)
    with pytest.raises(ValueError):
        params_to_flax({"convs.0.mlp.weight": torch.zeros(2, 2)})
    g1 = GIN(400, 300, 2, 4, generator=torch.Generator().manual_seed(1), device="cpu")
    g2 = GIN(400, 300, 2, 4, generator=torch.Generator().manual_seed(1), device="cpu")
    for pa, pb in zip(g1.parameters(), g2.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    w0 = g1.convs[0].mlp.lins[0].weight.detach()
    assert abs(float(w0.std()) * 400 ** 0.5 - 1.0) < 0.05
    assert float(g1.convs[0].mlp.lins[0].bias.detach().abs().max()) == 0.0
    assert MODELS["gin"] == (GIN, False) and MODELS["sgc"] == (SGC, True)
    assert MODELS["appnp"] == (APPNP, True)


@pytest.mark.parametrize("name", ["gin", "appnp"])
def test_train_lockstep_with_jax(name, tmp_path):
    """3 AdamW steps of GIN (trained eps) and APPNP (dropout off) over
    packed BAT graphs beside optax's adamw on the JAX model (its f32
    reference backend); then a checkpoint round trip through the
    reference's format, read back by the JAX package too."""
    from geot_tpu.graph.datasets import synthetic_classification_graph

    d = synthetic_classification_graph(200, 1200, 4, seed=6, feature_noise=0.4)
    x = d.x.astype(np.float32)
    jg, tg = _graphs(d.src, d.dst, 200, 16 if name == "gin" else 4, MODELS[name][1])
    extra = {"conv_kwargs": {"train_eps": True}} if name == "gin" else {"k": 3}
    jm = JMODELS[name][0](hidden_features=16, num_layers=3, out_features=4,
                          backend="reference", **extra)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jg)
    tx = optax.adamw(0.01, weight_decay=5e-4)
    opt_state = tx.init(params)
    jstep = jtrain.make_train_step(jm, tx, has_dropout=False)
    tm = MODELS[name][0](x.shape[1], 16, 3, 4, device="cpu", **extra)
    tm.load_state_dict(params_from_flax(_np(params)))
    tstep = make_train_step(tm, make_optimizer(tm, 0.01, 5e-4), has_dropout=False)
    xt, yt = torch.from_numpy(x), torch.from_numpy(d.y.astype(np.int64))
    mt = torch.from_numpy(d.train_mask)
    rng = jax.random.PRNGKey(1)
    jgrad = jax.grad(lambda p: jtrain.cross_entropy_loss(
        jm.apply(p, jnp.asarray(x), jg), jnp.asarray(d.y), jnp.asarray(d.train_mask)))(params)
    for i in range(3):
        params, opt_state, rng, jl = jstep(params, opt_state, rng, jnp.asarray(x), jg,
                                           jnp.asarray(d.y), jnp.asarray(d.train_mask))
        tl = tstep(xt, tg, yt, mt)
        np.testing.assert_allclose(float(tl), float(jl), **TOL_F32)
        if i == 0:
            for k, g in params_from_flax(_np(jgrad)).items():
                np.testing.assert_allclose(dict(tm.named_parameters())[k].grad.numpy(),
                                           g.numpy(), rtol=1e-5,
                                           atol=1e-5 * float(g.abs().max()), err_msg=k)
    want = params_from_flax(_np(params))
    got = tm.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **TOL_ADAM, err_msg=k)
    ckpt = str(tmp_path / f"{name}.npz")
    save_checkpoint(ckpt, got, {"steps": 3})
    restored, meta = load_checkpoint(ckpt)
    assert meta == {"steps": 3}
    for k, v in got.items():
        torch.testing.assert_close(restored[k], v, rtol=0, atol=0)
    jrestored, _ = jtrain.load_checkpoint(ckpt)
    flat = jax.tree_util.tree_leaves(jrestored["params"])
    assert len(flat) == len(got)
    if name == "gin":
        np.testing.assert_array_equal(np.asarray(jrestored["params"]["GINConv_2"]["eps"]),
                                      got["convs.2.eps"].numpy())
    else:
        np.testing.assert_array_equal(np.asarray(jrestored["params"]["Dense_1"]["kernel"]),
                                      got["lins.1.weight"].numpy().T)
