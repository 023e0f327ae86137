"""The port's GAT, and GCN with per-call weights over slot plans
(`slot_dyn`), against the JAX package's flax models: GATConv and GAT
forward passes with the same weights, the GAT weight tree and its init,
3-step AdamW lockstep with optax for both models, and GAT checkpoints
that load in either package.

Inputs come from numpy with a seed and go through both packages; JAX runs
its Pallas kernels in interpret mode. Tolerances: GAT forward 1e-4 (the
JAX GAT test's own); the trainers, whose JAX side runs its f32 reference
backend, 1e-5 as `test_torch_train.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geot_tpu.graph.datasets import synthetic_classification_graph
from geot_tpu.models import GAT as JGAT
from geot_tpu.models import GCN as JGCN
from geot_tpu.models import prepare_graph as jprepare_graph
from geot_tpu.models import train as jtrain
from geot_tpu.models.conv import GATConv as JGATConv
from geot_tpu_torch.models import (
    GAT,
    GCN,
    MODELS,
    GATConv,
    load_checkpoint,
    make_optimizer,
    make_train_step,
    params_from_flax,
    params_to_flax,
    prepare_graph,
    save_checkpoint,
)
from geot_tpu_torch.ops import api as tapi

TOL_GAT = dict(rtol=1e-4, atol=1e-4)
TOL_F32 = dict(rtol=1e-5, atol=1e-5)


def _np(params):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


def _pair(rng, n=150, e=900, **kw):
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    kw = dict(e_tile=64, s_tile=64, feature_hint=128, **kw)
    jg = jprepare_graph(src, dst, n, add_self_loops=True, layouts=("slot",), **kw)
    tg = prepare_graph(src, dst, n, add_self_loops=True, layouts=("slot",), device="cpu", **kw)
    return jg, tg, n


@pytest.mark.parametrize("concat", [True, False])
def test_gatconv_matches_flax(concat):
    """GATConv (4 heads of 6) with the flax weights carried across, against
    flax's GATConv; with zero attention vectors the attention is uniform
    and each head is the mean of its in-neighbours (mirror of
    tests/test_models.py::test_gatconv_rowstochastic_and_shape)."""
    rng = np.random.default_rng(3 + concat)
    jg, tg, n = _pair(rng)
    x = rng.standard_normal((n, 10)).astype(np.float32)
    jc = JGATConv(features=6, heads=4, concat=concat, backend="pallas")
    params = jc.init(jax.random.PRNGKey(1), jnp.asarray(x), jg)
    j = np.asarray(jc.apply(params, jnp.asarray(x), jg))
    tc = GATConv(10, 6, heads=4, concat=concat, device="cpu")
    p = _np(params)["params"]
    state = params_from_flax({"GATConv_0": p})
    tc.load_state_dict({k.split(".", 2)[2]: v for k, v in state.items()})
    with torch.inference_mode():
        t = tc(torch.from_numpy(x), tg)
    assert t.shape == (n, 24 if concat else 6) and torch.isfinite(t).all()
    np.testing.assert_allclose(t.numpy(), j, **TOL_GAT)
    with torch.no_grad():
        tc.att_src.zero_()
        tc.att_dst.zero_()
        u = tc(torch.from_numpy(x), tg)
    a = np.zeros((n, n))
    np.add.at(a, (tg.dst.numpy(), tg.src.numpy()), 1.0)
    xh = (x.astype(np.float64) @ p["Dense_0"]["kernel"].astype(np.float64)).reshape(n, 4, 6)
    ref = np.einsum("ij,jhd->ihd", a, xh) / np.maximum(a.sum(1), 1.0)[:, None, None]
    ref = ref.reshape(n, 24) if concat else ref.mean(axis=1)
    np.testing.assert_allclose(u.numpy(), ref + p["bias"], **TOL_GAT)


def test_gat_matches_flax_and_weights_round_trip():
    """A 3-layer GAT (4 heads averaged, hidden 8) with the flax weights,
    against flax's GAT; the weight tree round-trips; the init is flax's
    glorot uniform (bounds sqrt(6 / (fan_in + fan_out)), attention vectors
    by (heads, features)) from the generator; MODELS["gat"]."""
    rng = np.random.default_rng(7)
    jg, tg, n = _pair(rng)
    x = rng.standard_normal((n, 12)).astype(np.float32)
    ck = {"heads": 4, "concat": False}
    jm = JGAT(hidden_features=8, num_layers=3, out_features=5, conv_kwargs=ck,
              backend="pallas")
    params = jm.init(jax.random.PRNGKey(5), jnp.asarray(x), jg)
    j = np.asarray(jm.apply(params, jnp.asarray(x), jg))
    tm = GAT(12, 8, 3, 5, conv_kwargs=ck, device="cpu").eval()
    tm.load_state_dict(params_from_flax(_np(params)))  # strict
    with torch.inference_mode():
        t = tm(torch.from_numpy(x), tg)
    assert t.shape == (n, 5)
    np.testing.assert_allclose(t.numpy(), j, **TOL_GAT)
    back = params_to_flax(tm.state_dict())
    flat_j = jax.tree_util.tree_leaves_with_path(_np(params))
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [q for q, _ in flat_j] == [q for q, _ in flat_b]
    for (_, a), (_, b) in zip(flat_j, flat_b):
        np.testing.assert_array_equal(a, b)
    assert MODELS["gat"] == (GAT, True)
    g1 = GAT(300, 200, 2, 4, conv_kwargs=ck, generator=torch.Generator().manual_seed(1),
             device="cpu")
    g2 = GAT(300, 200, 2, 4, conv_kwargs=ck, generator=torch.Generator().manual_seed(1),
             device="cpu")
    for a, b in zip(g1.parameters(), g2.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    c0 = g1.convs[0].requires_grad_(False)
    bound = (6.0 / (300 + 800)) ** 0.5
    assert float(c0.lin.weight.abs().max()) <= bound
    assert float(c0.lin.weight.abs().max()) > 0.99 * bound
    bound_att = (6.0 / (4 + 200)) ** 0.5
    assert float(c0.att_src.abs().max()) <= bound_att
    assert float(c0.att_dst.abs().max()) > 0.95 * bound_att
    assert float(c0.bias.abs().max()) == 0.0 and c0.bias.shape == (200,)


def _lockstep(jm, tm, jg, tg, d, steps=3):
    """`steps` AdamW steps of the flax model (optax, its reference backend)
    beside the port's (its kernel path, plain on the CPU) from the same
    weights; losses and final parameters within TOL_F32. Returns the
    port's state dict."""
    x = d.x.astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jg)
    tx = optax.adamw(0.01, weight_decay=5e-4)
    opt_state = tx.init(params)
    jstep = jtrain.make_train_step(jm, tx, has_dropout=False)
    tm.load_state_dict(params_from_flax(_np(params)))
    tstep = make_train_step(tm, make_optimizer(tm, 0.01, 5e-4), has_dropout=False)
    xt, yt = torch.from_numpy(x), torch.from_numpy(d.y.astype(np.int64))
    mt = torch.from_numpy(d.train_mask)
    rng = jax.random.PRNGKey(1)
    for _ in range(steps):
        params, opt_state, rng, jl = jstep(params, opt_state, rng, jnp.asarray(x), jg,
                                           jnp.asarray(d.y), jnp.asarray(d.train_mask))
        tl = tstep(xt, tg, yt, mt)
        np.testing.assert_allclose(float(tl), float(jl), **TOL_F32)
    want = params_from_flax(_np(params))
    got = tm.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **TOL_F32, err_msg=k)
    return got


def _train_data(feature_hint=128):
    d = synthetic_classification_graph(200, 1200, 4, seed=6, feature_noise=0.4)
    kw = dict(e_tile=64, s_tile=128, feature_hint=feature_hint, layouts=("slot",))
    jg = jprepare_graph(d.src, d.dst, 200, add_self_loops=True, **kw)
    tg = prepare_graph(d.src, d.dst, 200, add_self_loops=True, prefer_dyn="sr", device="cpu",
                       **kw)
    return d, jg, tg


def test_gat_train_lockstep_with_jax(tmp_path):
    """3 AdamW steps of a 3-layer GAT (2 heads averaged) beside optax on
    the flax GAT; then a GAT checkpoint written by the port loads in the
    JAX package and gives its model the same output, and one written by
    the JAX package loads in the port."""
    d, jg, tg = _train_data()
    ck = {"heads": 2, "concat": False}
    jm = JGAT(hidden_features=16, num_layers=3, out_features=4, conv_kwargs=ck,
              backend="reference")
    tm = GAT(d.x.shape[1], 16, 3, 4, conv_kwargs=ck, device="cpu")
    got = _lockstep(jm, tm, jg, tg, d)
    ckpt = str(tmp_path / "gat.npz")
    save_checkpoint(ckpt, got, {"steps": 3})
    restored, meta = load_checkpoint(ckpt)
    assert meta == {"steps": 3}
    for k, v in got.items():
        torch.testing.assert_close(restored[k], v, rtol=0, atol=0)
    jrestored, _ = jtrain.load_checkpoint(ckpt)
    x = d.x.astype(np.float32)
    jout = np.asarray(jm.apply(jrestored, jnp.asarray(x), jg))
    tm.eval()
    with torch.inference_mode():
        tout = tm(torch.from_numpy(x), tg)
    np.testing.assert_allclose(tout.numpy(), jout, **TOL_GAT)
    jpath = str(tmp_path / "gat_jax.npz")
    jtrain.save_checkpoint(jpath, jrestored, {"from": "jax"})
    back, meta = load_checkpoint(jpath)
    assert meta == {"from": "jax"}
    for k, v in got.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("feature_hint", [64, 128])
def test_gcn_slot_dyn_train_lockstep_with_jax(feature_hint):
    """GCN over a slot graph without a baked norm: GCNConv computes the
    norm per forward and passes it as per-call weights, which take the
    slot_dyn route (feature_hint 64: pack-aligned plans, the packed AEB
    kernel at widths <= 64; 128: sr2 over slot-ordered values). 3 AdamW
    steps beside optax on the flax GCN."""
    d, jg, tg = _train_data(feature_hint)
    assert tg.w_slots is None and tapi.dispatch_path(tg, dynamic_w=True) == "slot_dyn"
    jm = JGCN(hidden_features=16, num_layers=3, out_features=4, backend="reference")
    tm = GCN(d.x.shape[1], 16, 3, 4, device="cpu")
    _lockstep(jm, tm, jg, tg, d)
