"""BasicGNN's norm, jk and act_first against the flax models, and the real
data end to end through the port's prepare_graph.

The flax variables of `geot_tpu.models` (params and, for BatchNorm,
`batch_stats`, set to random running averages) are carried into the port
by `params_from_flax`; the JAX models run on their reference path and the
port's over BAT plans on the CPU: f32 sums of the same terms in other
orders, so rtol/atol 2e-4 (tests/test_ops.py's SpMM bound) for outputs.
Gradients are held per tensor (`_check_grads`, ROADMAP C.19) against
JAX's at rtol 2e-4 and atol 2e-4 times the tensor's own float64 scale,
with JAX's f32 gradients held to the port's float64 reference path by
the same rule (a fault the port's paths share cannot hide), and the
port's f32 gradient no farther from float64 than its f32 reference
path's, a factor 2 at most, in the relative (Frobenius) distance. Only a
tensor whose exact gradient is 0 (the bias of a conv ahead of a
training-mode BatchNorm) takes the model's largest gradient as its scale.
BatchNorm in training mode is
held against `model.apply(..., deterministic=False,
mutable=["batch_stats"])`: its output, gradients and updated running
averages (flax's momentum 0.99 and biased variance).

Mirrors tests/test_realdata.py's rmat and lesmis tests on the port.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geot_tpu.graph.structures import build_graph as jbuild_graph
from geot_tpu.models import GCN as JGCN
from geot_tpu.models import GraphSAGE as JSAGE
from geot_tpu.models import train as jtrain
from geot_tpu_torch.graph.datasets import load_npz, rmat_graph
from geot_tpu_torch.graph.structures import build_graph as tbuild_graph
from geot_tpu_torch.models import (
    GCN,
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

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TOL = dict(rtol=2e-4, atol=2e-4)
TILES = dict(e_tile=64, s_tile=32, bat_e_tile=64, bat_s_tile=32, feature_hint=128)
MODELS = {"gcn": (JGCN, GCN), "graphsage": (JSAGE, GraphSAGE)}


def _graphs(seed=0, n=200, nnz=1600):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, nnz).astype(np.int32)
    dst = rng.integers(0, n, nnz).astype(np.int32)
    loop = np.arange(n, dtype=np.int32)
    src, dst = np.concatenate([src, loop]), np.concatenate([dst, loop])
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    jg = jbuild_graph(src, dst, n, assume_sorted=True, layouts=("bat",), **TILES)
    tg = tbuild_graph(src, dst, n, assume_sorted=True, layouts=("bat",), device="cpu", **TILES)
    return rng, n, jg, tg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _variables(jm, x, jg, rng):
    """Initialised flax variables, BatchNorm's running averages random."""
    v = _np(jm.init(jax.random.PRNGKey(7), jnp.asarray(x), jg))
    for bs in v.get("batch_stats", {}).values():
        bs["mean"] = rng.standard_normal(bs["mean"].shape).astype(np.float32) * 0.3
        bs["var"] = rng.uniform(0.5, 2.0, bs["var"].shape).astype(np.float32)
    return v


def _models(kind, norm, jk, act_first, x, jg, rng, width=16):
    jcls, tcls = MODELS[kind]
    kw = dict(norm=norm, jk=jk, act_first=act_first)
    jm = jcls(hidden_features=width, num_layers=3, out_features=5, backend="reference", **kw)
    v = _variables(jm, x, jg, rng)
    tm = tcls(x.shape[1], width, 3, 5, device="cpu", **kw)
    tm.load_state_dict(params_from_flax(v))
    return jm, v, tm


def _ref_grads(tm, kind, norm, jk, act_first, x, tg, cot, dtype, width=16):
    """Every parameter's gradient of <model(x), cot> on the port's
    reference path in `dtype`, from tm's state and in tm's mode (tm as
    `_models` builds it)."""
    m = MODELS[kind][1](x.shape[1], width, 3, 5, norm=norm, jk=jk, act_first=act_first,
                        backend="reference", device="cpu").to(dtype)
    m.load_state_dict(tm.state_dict())
    m.train(tm.training)
    out = m(torch.from_numpy(x).to(dtype), tg)
    (out * torch.from_numpy(cot).to(dtype)).sum().backward()
    return {k: p.grad for k, p in m.named_parameters()}


def _check_grads(tm, jgrads, batch_stats, args):
    """Per tensor (ROADMAP C.19), with `args` (kind, norm, jk, act_first,
    x, tg, cot) for the port's reference path in float64 and float32:

    - the port's f32 gradient against JAX's, rtol 2e-4 and atol 2e-4 times
      the tensor's largest float64 entry;
    - JAX's f32 gradient against float64 by the same rule, so a fault the
      port's kernel and reference paths share cannot hide;
    - the port's f32 gradient no farther from float64 than the port's f32
      reference path, a factor 2 at most, in ||g - g64|| / ||g64||.

    A tensor whose exact gradient is 0 (the bias of a conv ahead of a
    training-mode BatchNorm: float64 leaves ~1e-15) has no scale of its
    own and takes the model's largest float64 entry."""
    want = params_from_flax({"params": jgrads, "batch_stats": batch_stats})
    got = {k: p.grad for k, p in tm.named_parameters()}
    g64 = _ref_grads(tm, *args, dtype=torch.float64)
    g32 = _ref_grads(tm, *args, dtype=torch.float32)
    assert set(got) <= set(want) and set(got) == set(g64) == set(g32)
    model = max(float(g64[k].abs().max()) for k in got)
    for k, g in got.items():
        h = g64[k]
        own = float(h.abs().max())
        scale = own if own > 1e-12 * model else model
        tol = dict(rtol=2e-4, atol=2e-4 * scale, msg=lambda m: f"{k}: {m}")
        torch.testing.assert_close(g, want[k], **tol)
        torch.testing.assert_close(want[k].double(), h, **tol)
        norm = max(float(h.norm()), 1e-12 * model)
        e_kernel = float((g.double() - h).norm()) / norm
        e_ref = float((g32[k].double() - h).norm()) / norm
        assert e_kernel <= 2 * e_ref, (f"{k}: relative distance from float64 {e_kernel:.3e}, "
                                       f"past twice the f32 reference path's {e_ref:.3e}")


CASES = ([(n, j, False) for n in ("layer", "batch") for j in (None, "last", "cat", "max")]
         + [(None, j, False) for j in ("last", "cat", "max")]
         + [("layer", "cat", True), ("batch", "max", True), (None, None, True)])


@pytest.mark.parametrize("norm,jk,act_first", CASES)
def test_gcn_norm_jk_vs_flax(norm, jk, act_first):
    """Forward (eval: BatchNorm on its running averages) and every
    parameter's gradient."""
    rng, n, jg, tg = _graphs()
    x = rng.standard_normal((n, 12)).astype(np.float32)
    cot = rng.standard_normal((n, 5)).astype(np.float32)
    jm, v, tm = _models("gcn", norm, jk, act_first, x, jg, rng)
    tm.eval()
    out = tm(torch.from_numpy(x), tg)
    j = jm.apply(v, jnp.asarray(x), jg)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j), **TOL)
    (out * torch.from_numpy(cot)).sum().backward()
    rest = {k: v[k] for k in v if k != "params"}
    gj = jax.grad(lambda p: jnp.vdot(jm.apply({"params": p, **rest}, jnp.asarray(x), jg),
                                     cot))(v["params"])
    _check_grads(tm, _np(gj), v.get("batch_stats", {}), ("gcn", norm, jk, act_first, x, tg, cot))


@pytest.mark.parametrize("kind", ["gcn", "graphsage"])
@pytest.mark.parametrize("jk,act_first", [(None, False), ("cat", True), ("max", False)])
def test_batchnorm_training_mode_vs_flax(kind, jk, act_first):
    """Batch statistics in the forward, their gradients, and the running
    averages after it, against flax's mutable batch_stats."""
    rng, n, jg, tg = _graphs(seed=1)
    x = rng.standard_normal((n, 12)).astype(np.float32)
    cot = rng.standard_normal((n, 5)).astype(np.float32)
    jm, v, tm = _models(kind, "batch", jk, act_first, x, jg, rng)
    tm.train()
    out = tm(torch.from_numpy(x), tg)
    (out * torch.from_numpy(cot)).sum().backward()

    def f(p):
        o, upd = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, jnp.asarray(x), jg,
                          deterministic=False, mutable=["batch_stats"])
        return jnp.vdot(o, cot), (o, upd)

    (_, (j, upd)), gj = jax.value_and_grad(f, has_aux=True)(v["params"])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j), **TOL)
    _check_grads(tm, _np(gj), v["batch_stats"], (kind, "batch", jk, act_first, x, tg, cot))
    want = params_from_flax({"params": v["params"], "batch_stats": _np(upd["batch_stats"])})
    for k, t in tm.state_dict().items():
        if "running_" in k:
            torch.testing.assert_close(t, want[k], rtol=1e-5, atol=1e-6)


def test_train_step_runs_batchnorm_on_running_averages():
    """Without dropout the trainer runs the model in eval mode, as the
    reference's (deterministic=True): BatchNorm normalizes by its running
    averages and leaves them as they are."""
    rng, n, jg, tg = _graphs(seed=2)
    x = torch.from_numpy(rng.standard_normal((n, 12)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 5, n))
    mask = torch.ones(n, dtype=torch.bool)
    tm = GCN(12, 16, 3, 5, norm="batch", jk="cat", device="cpu",
             generator=torch.Generator().manual_seed(0))
    before = {k: t.clone() for k, t in tm.state_dict().items() if "running_" in k}
    step = make_train_step(tm, make_optimizer(tm, 0.01, 5e-4), has_dropout=False)
    losses = [float(step(x, tg, y, mask)) for _ in range(3)]
    assert not tm.training and losses[-1] < losses[0]
    for k, t in before.items():
        assert torch.equal(tm.state_dict()[k], t)


@pytest.mark.parametrize("norm,jk", [("batch", "cat"), ("layer", "max"), ("batch", None)])
def test_weight_tree_and_checkpoint_roundtrip(norm, jk, tmp_path):
    """params_to_flax gives the flax variables back (LayerNorm_i,
    BatchNorm_i and its batch_stats, the jk head Dense_0), and a checkpoint
    written by the port loads in the reference and back."""
    rng, n, jg, tg = _graphs(seed=3)
    x = rng.standard_normal((n, 12)).astype(np.float32)
    jm, v, tm = _models("gcn", norm, jk, False, x, jg, rng)
    tree = params_to_flax(tm.state_dict())
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(v)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(v)):
        np.testing.assert_array_equal(a, b)
    path = str(tmp_path / "m.ckpt.npz")
    save_checkpoint(path, tm.state_dict(), {"acc": 0.5})
    jv, meta = jtrain.load_checkpoint(path)
    assert meta == {"acc": 0.5}
    np.testing.assert_allclose(np.asarray(jm.apply(jv, jnp.asarray(x), jg)),
                               np.asarray(jm.apply(v, jnp.asarray(x), jg)), rtol=0, atol=0)
    state, _ = load_checkpoint(path)
    assert state.keys() == tm.state_dict().keys()
    for k, t in tm.state_dict().items():
        assert torch.equal(state[k], t)


def test_rmat_graph500_end_to_end():
    """tests/test_realdata.py's rmat test on the port: the graph is
    bit-reproducible with a power-law skew, and the weighted SpMM over the
    port's prepare_graph matches the float64 segment sum."""
    d1, d2 = rmat_graph(13), rmat_graph(13)
    assert d1.num_edges == 131072 and d1.num_nodes == 8192
    np.testing.assert_array_equal(d1.src, d2.src)
    np.testing.assert_array_equal(d1.dst, d2.dst)
    deg = np.sort(np.bincount(d1.dst, minlength=d1.num_nodes))[::-1]
    assert deg[: d1.num_nodes // 100].sum() > 0.25 * d1.num_edges
    w = np.random.default_rng(0).standard_normal(d1.num_edges).astype(np.float32)
    g = prepare_graph(d1.src, d1.dst, d1.num_nodes, add_self_loops=False, edge_weight=w,
                      layouts=("bat",), device="cpu")
    x = np.random.default_rng(1).standard_normal((d1.num_nodes, 32)).astype(np.float32)
    out = tapi.segment_spmm(g, torch.from_numpy(x))
    ref = np.zeros((d1.num_nodes, 32))
    np.add.at(ref, g.dst.numpy(), x[g.src.numpy()] * g.edge_weight.numpy()[:, None])
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_lesmis_weighted_spmm_oracle():
    """tests/test_realdata.py's lesmis test on the port: the real weighted
    graph through the fused SpMM against a dense float64 oracle."""
    d = load_npz(os.path.join(FIXTURES, "lesmis.npz"))
    assert d.edge_weight is not None and d.num_nodes == 77
    g = prepare_graph(d.src, d.dst, d.num_nodes, add_self_loops=False,
                      edge_weight=d.edge_weight, feature_hint=16, device="cpu")
    out = tapi.segment_spmm(g, torch.from_numpy(np.asarray(d.x, np.float32)))
    adj = np.zeros((d.num_nodes, d.num_nodes))
    np.add.at(adj, (d.dst, d.src), np.asarray(d.edge_weight, np.float64))
    np.testing.assert_allclose(out.numpy(), adj @ np.asarray(d.x, np.float64), **TOL)
