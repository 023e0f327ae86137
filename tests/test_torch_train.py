"""The port's trainer and checkpoints against the JAX package's.

The same flax GCN params go into the JAX `make_train_step(optax.adamw)`
and, through `params_from_flax`, into the port's `make_train_step`
(`torch.optim.AdamW`, the same decoupled update). The JAX model runs its
f32 reference backend: Adam's first update is close to lr * sign(g), so
the bf16 hi/lo split of the interpret-mode Pallas path would be amplified
in the parameters. Tolerance 1e-5 on losses and parameters (f32 sums in
other orders, three steps), and on logits against the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geot_tpu.graph.datasets import synthetic_classification_graph
from geot_tpu.graph.structures import build_graph as jbuild_graph
from geot_tpu.models import GCN as JGCN
from geot_tpu.models import prepare_graph as jprepare_graph
from geot_tpu.models import train as jtrain
from geot_tpu_torch.models import (
    GCN,
    load_checkpoint,
    make_optimizer,
    make_train_step,
    params_from_flax,
    params_to_flax,
    prepare_graph,
    save_checkpoint,
    train_node_classifier,
)
from geot_tpu_torch.models import train as ttrain

TOL_F32 = dict(rtol=1e-5, atol=1e-5)
TILES = dict(e_tile=64, s_tile=32, bat_e_tile=64, bat_s_tile=32, feature_hint=128)


def _pair(src, dst, n, monkeypatch, budget=1 << 30):
    """(JAX graph, port graph) over the same self-looped edges and tiles."""
    monkeypatch.setenv("GEOT_MAX_CHUNK_BYTES", str(budget))
    j0 = jprepare_graph(src, dst, n, layouts=("bat",), e_tile=64, s_tile=32)
    jg = jbuild_graph(np.asarray(j0.src), np.asarray(j0.dst), n, assume_sorted=True,
                      layouts=("bat",), **TILES)
    tg = prepare_graph(src, dst, n, max_chunk_bytes=budget, device="cpu", **TILES)
    np.testing.assert_array_equal(np.asarray(jg.src), tg.src.numpy())
    assert jg.bat.chunks == tg.bat.chunks and jg.bat_t.chunks == tg.bat_t.chunks
    return jg, tg


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


def _data(seed=6):
    return synthetic_classification_graph(200, 1200, 4, seed=seed, feature_noise=0.4)


@pytest.mark.parametrize("chunked", [False, True])
def test_train_step_lockstep_with_jax(chunked, monkeypatch):
    d = _data()
    x = d.x.astype(np.float32)
    budget = 3 * 64 * 128 * 4 if chunked else 1 << 30
    jg, tg = _pair(d.src, d.dst, 200, monkeypatch, budget)
    assert bool(tg.bat.chunks) == chunked
    jm = JGCN(hidden_features=16, num_layers=3, out_features=4, backend="reference")
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jg)
    tx = optax.adamw(0.01, weight_decay=5e-4)
    opt_state = tx.init(params)
    jstep = jtrain.make_train_step(jm, tx, has_dropout=False)
    tm = GCN(x.shape[1], 16, 3, 4, device="cpu")
    tm.load_state_dict(params_from_flax(_np_tree(params)))
    tstep = make_train_step(tm, make_optimizer(tm, 0.01, 5e-4), has_dropout=False)
    xt, yt = torch.from_numpy(x), torch.from_numpy(d.y.astype(np.int64))
    mt = torch.from_numpy(d.train_mask)
    rng = jax.random.PRNGKey(1)
    for _ in range(3):
        params, opt_state, rng, jl = jstep(params, opt_state, rng, jnp.asarray(x), jg,
                                           jnp.asarray(d.y), jnp.asarray(d.train_mask))
        tl = tstep(xt, tg, yt, mt)
        np.testing.assert_allclose(float(tl), float(jl), **TOL_F32)
    want = params_from_flax(_np_tree(params))
    got = tm.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **TOL_F32, err_msg=k)


def test_gcn_trains_on_separable_graph(tmp_path):
    """Port of test_models.test_gcn_trains_on_separable_graph: the same
    bar (train accuracy > 0.9, validation > 0.75) and a checkpoint round
    trip."""
    d = _data()
    g = prepare_graph(d.src, d.dst, 200, add_self_loops=True, e_tile=128, s_tile=128,
                      bat_e_tile=128, bat_s_tile=128, device="cpu")
    model = GCN(d.x.shape[1], 16, 2, 4, generator=torch.Generator().manual_seed(0),
                device="cpu")
    ckpt = str(tmp_path / "gcn_ckpt.npz")
    x = torch.from_numpy(d.x.astype(np.float32))
    state, metrics = train_node_classifier(
        model, g, x, torch.from_numpy(d.y.astype(np.int64)),
        torch.from_numpy(d.train_mask), torch.from_numpy(d.val_mask),
        epochs=120, lr=0.02, checkpoint_path=ckpt,
    )
    assert metrics["train_acc"] > 0.9, metrics
    assert metrics["val_acc"] > 0.75, metrics
    restored, meta = load_checkpoint(ckpt)
    m2 = GCN(d.x.shape[1], 16, 2, 4, device="cpu").eval()
    m2.load_state_dict(restored)
    model.eval()
    with torch.no_grad():
        torch.testing.assert_close(m2(x, g), model(x, g), rtol=1e-6, atol=0)
    assert meta["train_acc"] == metrics["train_acc"]
    for k, v in state.items():
        torch.testing.assert_close(restored[k], v, rtol=0, atol=0)


def test_checkpoint_interop_with_jax(tmp_path, monkeypatch):
    """A checkpoint written by the JAX package loads into the port's GCN
    and gives the JAX model's logits; one written by the port loads with
    the JAX `load_checkpoint` into the same flax tree."""
    rng = np.random.default_rng(9)
    n = 150
    src = rng.integers(0, n, 900).astype(np.int32)
    dst = rng.integers(0, n, 900).astype(np.int32)
    jg, tg = _pair(src, dst, n, monkeypatch)
    x = rng.standard_normal((n, 12)).astype(np.float32)
    jm = JGCN(hidden_features=16, num_layers=3, out_features=5, backend="reference")
    params = jm.init(jax.random.PRNGKey(4), jnp.asarray(x), jg)
    jlogits = np.asarray(jm.apply(params, jnp.asarray(x), jg))

    jpath = str(tmp_path / "from_jax.npz")
    jtrain.save_checkpoint(jpath, params, {"epoch": 3})
    state, meta = load_checkpoint(jpath)
    assert meta == {"epoch": 3}
    tm = GCN(12, 16, 3, 5, device="cpu").eval()
    tm.load_state_dict(state)
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(x), tg).numpy(), jlogits, **TOL_F32)

    tpath = str(tmp_path / "from_port.npz")
    save_checkpoint(tpath, tm.state_dict(), {"acc": 0.5})
    back, meta2 = jtrain.load_checkpoint(tpath)
    assert meta2 == {"acc": 0.5}
    want = _np_tree(params)
    assert (jax.tree_util.tree_structure(_np_tree(back))
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(_np_tree(back)), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(np.asarray(jm.apply(back, jnp.asarray(x), jg)), jlogits,
                               rtol=0, atol=0)
    # the two files hold the same manifest (leaf order and key paths)
    assert bytes(np.load(jpath)["__paths__"]) == bytes(np.load(tpath)["__paths__"])
    # a JAX checkpoint of another tree (a list) is refused, not misread
    lpath = str(tmp_path / "list.npz")
    jtrain.save_checkpoint(lpath, [np.zeros(2, np.float32)])
    with pytest.raises(ValueError, match="tree of dicts"):
        load_checkpoint(lpath)


def test_params_to_flax_inverts_params_from_flax():
    m = GCN(6, 8, 3, 2, generator=torch.Generator().manual_seed(2), device="cpu")
    tree = params_to_flax(m.state_dict())
    assert sorted(tree["params"]) == ["GCNConv_0", "GCNConv_1", "GCNConv_2"]
    assert tree["params"]["GCNConv_0"]["Dense_0"]["kernel"].shape == (6, 8)
    back = params_from_flax(tree)
    for k, v in m.state_dict().items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    with pytest.raises(ValueError):
        params_to_flax({"lin.weight": torch.zeros(2, 2)})


def test_dropout_draws_from_the_callers_generator():
    torch.manual_seed(0)
    m = GCN(8, 64, 2, 3, dropout_rate=0.5, generator=torch.Generator().manual_seed(1),
            device="cpu")
    g = prepare_graph(np.array([0, 1, 2], np.int32), np.array([1, 2, 0], np.int32), 3,
                      device="cpu", bat_e_tile=32, bat_s_tile=4)
    x = torch.randn(3, 8)
    m.train()
    with pytest.raises(ValueError, match="Generator"):
        m(x, g)
    a = m(x, g, torch.Generator().manual_seed(7))
    state = torch.get_rng_state()
    b = m(x, g, torch.Generator().manual_seed(7))
    c = m(x, g, torch.Generator().manual_seed(8))
    assert torch.equal(state, torch.get_rng_state())  # the global RNG is untouched
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    # keep rate 1 - p, kept values scaled by 1 / (1 - p), as flax's Dropout
    h = torch.ones(200, 64)
    out = m._dropout(h, torch.Generator().manual_seed(3))
    assert set(out.unique().tolist()) == {0.0, 2.0}
    assert abs(float((out > 0).float().mean()) - 0.5) < 0.02
    # a generator on another device than the activations is refused, not
    # drawn there and copied over
    with pytest.raises(ValueError, match="activations' device"):
        m._dropout(torch.ones(4, 64, device="meta"), torch.Generator().manual_seed(3))
    m.eval()
    with torch.no_grad():
        torch.testing.assert_close(m(x, g), m(x, g, torch.Generator().manual_seed(7)))


def test_loss_and_accuracy_match_jax():
    rng = np.random.default_rng(12)
    logits = rng.standard_normal((50, 7)).astype(np.float32)
    y = rng.integers(0, 7, 50)
    mask = rng.random(50) < 0.6
    np.testing.assert_allclose(
        float(ttrain.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(y),
                                        torch.from_numpy(mask))),
        float(jtrain.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(y), jnp.asarray(mask))),
        **TOL_F32)
    np.testing.assert_allclose(
        float(ttrain.accuracy(torch.from_numpy(logits), torch.from_numpy(y),
                              torch.from_numpy(mask))),
        float(jtrain.accuracy(jnp.asarray(logits), jnp.asarray(y), jnp.asarray(mask))),
        **TOL_F32)


def test_train_step_lockstep_with_jax_over_hybrid_graph():
    """Three AdamW steps of a GCN over a hybrid graph (the norm baked in by
    normalize="gcn", conv_kwargs={"normalize": False}): the port's steps
    run the hybrid path, forward and backward over `hyb_t`; the JAX model
    its f32 reference backend, as above. Weights carried by
    `params_from_flax`; tolerance 1e-5."""
    from geot_tpu.graph.datasets import synthetic_clustered_graph
    from geot_tpu_torch.ops.api import dispatch_path

    d = synthetic_clustered_graph(1024, 24_000, mixing=0.1, mean_community=256,
                                  feat_dim=12, num_classes=4, seed=1)
    j0 = jprepare_graph(d.src, d.dst, 1024, normalize="gcn", layouts=("bat",),
                        e_tile=64, s_tile=32)
    jg = jbuild_graph(np.asarray(j0.src), np.asarray(j0.dst), 1024,
                      edge_weight=np.asarray(j0.edge_weight), assume_sorted=True,
                      layouts=("bat", "stream"), **TILES)
    tg = prepare_graph(d.src, d.dst, 1024, normalize="gcn", layouts=("bat", "stream"),
                       device="cpu", **TILES)
    assert jg.hyb is not None and dispatch_path(tg) == "hybrid"
    kw = dict(conv_kwargs={"normalize": False})
    jm = JGCN(hidden_features=16, num_layers=3, out_features=4, backend="reference", **kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(d.x), jg)
    tx = optax.adamw(0.01, weight_decay=5e-4)
    opt_state = tx.init(params)
    jstep = jtrain.make_train_step(jm, tx, has_dropout=False)
    tm = GCN(12, 16, 3, 4, device="cpu", **kw)
    tm.load_state_dict(params_from_flax(_np_tree(params)))
    tstep = make_train_step(tm, make_optimizer(tm, 0.01, 5e-4), has_dropout=False)
    xt, yt = torch.from_numpy(d.x), torch.from_numpy(d.y.astype(np.int64))
    mt = torch.from_numpy(d.train_mask)
    rng = jax.random.PRNGKey(1)
    for _ in range(3):
        params, opt_state, rng, jl = jstep(params, opt_state, rng, jnp.asarray(d.x), jg,
                                           jnp.asarray(d.y), jnp.asarray(d.train_mask))
        tl = tstep(xt, tg, yt, mt)
        np.testing.assert_allclose(float(tl), float(jl), **TOL_F32)
    want = params_from_flax(_np_tree(params))
    got = tm.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **TOL_F32, err_msg=k)
