"""The port's distributed GCN training against the JAX package's.

Mirrors `tests/test_dist_train.py`: the same 96-node graph (self-loops,
the GCN norm on the whole graph) is partitioned into 2 and 4 parts; JAX's
`make_dist_train_step` runs 3 Adam steps (lr 0.01) on the 8-device CPU
mesh, and the port's runs them in a spawned gloo group of as many ranks
from the same parameters, carried across with `params_from_jax`. Losses
are held at rtol 1e-4 and the final parameters at rtol 1e-3 / atol 1e-5
(JAX's own test's tolerances); every rank's losses and parameters must be
bit-identical; the first forward must not depend on the part count.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from geot_tpu.graph.datasets import synthetic_classification_graph
from geot_tpu.models.conv import gcn_edge_weight, prepare_graph
from geot_tpu.parallel import partition_graph as jpartition_graph
from geot_tpu.parallel.dist_train import init_gcn_params as jinit_gcn_params
from geot_tpu.parallel.dist_train import make_dist_train_step as jmake_dist_train_step
from geot_tpu.parallel.dist_train import shard_inputs as jshard_inputs
from geot_tpu_torch.parallel import (
    init_gcn_params,
    partition_graph,
    spawn_ranks,
    unblock_nodes,
)
from torch_parallel_worker import dist_train

STEPS = 3
DIMS = [8, 16, 4]


@functools.lru_cache(maxsize=None)
def _graph():
    d = synthetic_classification_graph(96, 600, 4, feat_dim=8, seed=0)
    g = prepare_graph(d.src, d.dst, d.num_nodes, add_self_loops=True, e_tile=32, s_tile=32)
    return dict(src=np.asarray(g.src), dst=np.asarray(g.dst),
                w=np.asarray(gcn_edge_weight(g)), x=d.x.astype(np.float32),
                y=d.y.astype(np.int64), train_mask=np.asarray(d.train_mask),
                num_nodes=d.num_nodes)


@functools.lru_cache(maxsize=None)
def _params():
    return {k: np.asarray(v) for k, v in jinit_gcn_params(jax.random.PRNGKey(0), DIMS).items()}


@functools.lru_cache(maxsize=None)
def _jax_run(P):
    devs = jax.devices()
    if len(devs) < P:
        pytest.skip(f"needs {P} devices")
    mesh = Mesh(np.array(devs[:P]), ("parts",))
    g = _graph()
    pg = jpartition_graph(g["src"], g["dst"], g["num_nodes"], P, edge_weight=g["w"],
                          e_tile=32, s_tile=32)
    params = {k: jnp.asarray(v) for k, v in _params().items()}
    tx = optax.adam(1e-2)
    opt = tx.init(params)
    step = jmake_dist_train_step(tx, pg, mesh, backend="reference")
    x, y, m = jshard_inputs(g["x"], g["y"].astype(np.int32), g["train_mask"], pg, mesh)
    losses = []
    for _ in range(STEPS):
        params, opt, loss = step(params, opt, x, y, m)
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in params.items()}


@functools.lru_cache(maxsize=None)
def _port_run(P):
    return spawn_ranks(dist_train, P, _graph(), _params(), STEPS, timeout=240.0)


@pytest.mark.parametrize("nparts", [2, 4])
def test_dist_train_steps_match_jax(nparts):
    losses_j, params_j = _jax_run(nparts)
    runs = _port_run(nparts)
    _, losses, params = runs[0]
    np.testing.assert_allclose(losses, losses_j, rtol=1e-4)
    for k, v in params_j.items():
        np.testing.assert_allclose(params[k], v, rtol=1e-3, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("nparts", [2, 4])
def test_dist_train_replicas_bit_identical(nparts):
    runs = _port_run(nparts)
    _, losses0, params0 = runs[0]
    assert len(losses0) == STEPS and all(np.isfinite(losses0))
    for _, losses, params in runs[1:]:
        assert losses == losses0
        for k, v in params0.items():
            np.testing.assert_array_equal(params[k], v, err_msg=k)


def test_dist_forward_part_count_invariance():
    g = _graph()
    outs = []
    for P in (2, 4):
        pg = partition_graph(g["src"], g["dst"], g["num_nodes"], P, edge_weight=g["w"],
                             e_tile=32, s_tile=32)
        blocked = torch.from_numpy(np.concatenate([r[0] for r in _port_run(P)]))
        assert blocked.shape == (pg.padded_nodes, DIMS[-1])
        outs.append(unblock_nodes(blocked, pg).numpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-4, atol=1e-5)


def test_init_gcn_params_from_a_generator():
    """Normal weights scaled by sqrt(2 / (a + b)), zero biases, leaves that
    require grad; the same generator seed gives the same parameters."""
    a = init_gcn_params(DIMS, generator=torch.Generator().manual_seed(3), device="cpu")
    b = init_gcn_params(DIMS, generator=torch.Generator().manual_seed(3), device="cpu")
    assert sorted(a) == ["b0", "b1", "w0", "w1"]
    for k in a:
        assert a[k].requires_grad and torch.equal(a[k], b[k])
    assert a["w0"].shape == (8, 16) and not a["b1"].any()
    big = init_gcn_params([256, 256], generator=torch.Generator().manual_seed(0),
                          device="cpu")["w0"].detach()
    assert abs(float(big.std()) - (2.0 / 512) ** 0.5) < 0.01
