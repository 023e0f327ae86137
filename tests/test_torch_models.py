"""The port's GCN against the JAX package's, with the same weights.

The flax params of `geot_tpu.models.GCN` are carried into the port by
`params_from_flax`; the graphs come from the same edges and explicit
tiles. JAX runs its Pallas kernels in interpret mode: tolerance 2e-3 (the
BAT path's bound in `test_ops.py`, from the hi/lo bf16 split).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geot_tpu.graph.structures import build_graph as jbuild_graph
from geot_tpu.models import GCN as JGCN
from geot_tpu.models import prepare_graph as jprepare_graph
from geot_tpu_torch.models import GCN, gcn_edge_weight, params_from_flax, prepare_graph

TOL_PALLAS = dict(rtol=2e-3, atol=2e-3)
TILES = dict(e_tile=64, s_tile=32, bat_e_tile=64, bat_s_tile=32, feature_hint=128)


def _edges(rng, n, nnz):
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** -1.0
    p /= p.sum()
    dst = rng.choice(n, size=nnz, p=p).astype(np.int32)
    src = rng.integers(0, n, nnz).astype(np.int32)
    return src, dst


def _pair(src, dst, n, normalize, monkeypatch, budget):
    """(JAX graph, port graph) over the same self-looped edges and tiles."""
    monkeypatch.setenv("GEOT_MAX_CHUNK_BYTES", str(budget))
    # the JAX prepare_graph asks the TPU table for BAT tiles; rebuild its
    # edges with the explicit tiles the port takes
    j0 = jprepare_graph(src, dst, n, normalize=normalize, layouts=("bat",),
                        e_tile=TILES["e_tile"], s_tile=TILES["s_tile"])
    jg = jbuild_graph(np.asarray(j0.src), np.asarray(j0.dst), n,
                      edge_weight=None if j0.edge_weight is None else np.asarray(j0.edge_weight),
                      assume_sorted=True, layouts=("bat",), **TILES)
    tg = prepare_graph(src, dst, n, normalize=normalize, max_chunk_bytes=budget,
                       layouts=("bat",), device="cpu", **TILES)
    np.testing.assert_array_equal(np.asarray(jg.src), tg.src.numpy())
    np.testing.assert_array_equal(np.asarray(jg.dst), tg.dst.numpy())
    np.testing.assert_array_equal(np.asarray(jg.bat.vblock), tg.bat.vblock.numpy())
    assert jg.bat.chunks == tg.bat.chunks
    if normalize:
        np.testing.assert_allclose(np.asarray(jg.edge_weight), tg.edge_weight.numpy(),
                                   rtol=1e-6, atol=1e-7)
    return jg, tg


def _flax_to_numpy(params):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


@pytest.mark.parametrize("widths", [(24, 16, 5), (32, 128, 40)])
@pytest.mark.parametrize("chunked", [False, True])
def test_gcn3_matches_jax(widths, chunked, monkeypatch):
    f_in, hidden, out = widths
    rng = np.random.default_rng(f_in + hidden + chunked)
    n = 300
    src, dst = _edges(rng, n, 2400)
    budget = 6 * 64 * 128 * 4 if chunked else 1 << 30
    jg, tg = _pair(src, dst, n, None, monkeypatch, budget)
    assert bool(tg.bat.chunks) == chunked
    x = rng.standard_normal((n, f_in)).astype(np.float32)
    jm = JGCN(hidden_features=hidden, num_layers=3, out_features=out, backend="pallas")
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x), jg)
    j = jm.apply(params, jnp.asarray(x), jg)

    tm = GCN(f_in, hidden, 3, out, device="cpu").eval()
    tm.load_state_dict(params_from_flax(_flax_to_numpy(params)))
    with torch.inference_mode():
        t = tm(torch.from_numpy(x), tg)
    assert t.shape == (n, out)
    assert torch.isfinite(t).all()
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL_PALLAS)


def test_gcn_edge_weight_matches_jax(monkeypatch):
    from geot_tpu.models.conv import gcn_edge_weight as jgcn_edge_weight

    rng = np.random.default_rng(2)
    src, dst = _edges(rng, 120, 900)
    jg, tg = _pair(src, dst, 120, None, monkeypatch, 1 << 30)
    np.testing.assert_allclose(gcn_edge_weight(tg).numpy(),
                               np.asarray(jgcn_edge_weight(jg)), rtol=1e-6, atol=1e-7)


def test_double_normalization_reproduced(monkeypatch):
    """prepare_graph(normalize='gcn') on a BAT-only graph leaves no slot
    weights, so GCNConv normalizes the baked weights again. The reference
    does this; the port reproduces it (ROADMAP §C), and the result differs
    from the singly normalized GCN."""
    rng = np.random.default_rng(4)
    n = 150
    src, dst = _edges(rng, n, 1200)
    jg, tg = _pair(src, dst, n, "gcn", monkeypatch, 1 << 30)
    assert jg.w_slots is None
    x = rng.standard_normal((n, 8)).astype(np.float32)
    jm = JGCN(hidden_features=16, num_layers=2, out_features=3, backend="pallas")
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jg)
    j = jm.apply(params, jnp.asarray(x), jg)
    tm = GCN(8, 16, 2, 3, device="cpu").eval()
    tm.load_state_dict(params_from_flax(_flax_to_numpy(params)))
    _, tg1 = _pair(src, dst, n, None, monkeypatch, 1 << 30)
    with torch.inference_mode():
        t = tm(torch.from_numpy(x), tg)
        single = tm(torch.from_numpy(x), tg1)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL_PALLAS)
    assert (t - single).abs().max() > 1e-3


def test_params_from_flax_layout():
    rng = np.random.default_rng(0)
    params = {"params": {
        f"GCNConv_{i}": {"Dense_0": {"kernel": rng.standard_normal((a, b)).astype(np.float32)},
                         "bias": rng.standard_normal(b).astype(np.float32)}
        for i, (a, b) in enumerate([(6, 4), (4, 4), (4, 2)])
    }}
    sd = params_from_flax(params)
    m = GCN(6, 4, 3, 2, device="cpu")
    m.load_state_dict(sd)  # strict: every key present, no extra
    np.testing.assert_array_equal(m.convs[0].lin.weight.detach().numpy(),
                                  params["params"]["GCNConv_0"]["Dense_0"]["kernel"].T)
    with pytest.raises(ValueError):
        params_from_flax({"Dense_0": {"kernel": np.zeros((2, 2))}})


def test_model_options_and_device_rules():
    # norm, jk and act_first are ported (tests/test_torch_basic_gnn.py);
    # an option the reference does not know is refused
    GCN(4, 4, 2, device="cpu", jk="cat", norm="layer", act_first=True)
    with pytest.raises(ValueError):
        GCN(4, 4, 2, device="cpu", jk="sum")
    with pytest.raises(ValueError):
        GCN(4, 4, 2, device="cpu", norm="group")
    if not torch.cuda.is_available():
        # the default device is the card: no silent CPU fallback
        with pytest.raises(RuntimeError, match="CUDA"):
            GCN(4, 4, 2)
    # glorot init from an explicit generator is reproducible
    a = GCN(8, 16, 2, 4, generator=torch.Generator().manual_seed(1), device="cpu")
    b = GCN(8, 16, 2, 4, generator=torch.Generator().manual_seed(1), device="cpu")
    for pa, pb in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    lim = (6 / (8 + 16)) ** 0.5
    assert a.convs[0].lin.weight.abs().max() <= lim


@pytest.mark.parametrize("improved", [False, True])
def test_gcnconv_options_match_jax(improved, monkeypatch):
    """GCNConv without normalization or bias, over a graph prepared with
    caller weights (existing self-loops replaced, fill 2 with `improved`)."""
    from geot_tpu.models import GCNConv as JGCNConv
    from geot_tpu_torch.models import GCNConv

    monkeypatch.setenv("GEOT_MAX_CHUNK_BYTES", str(1 << 30))
    rng = np.random.default_rng(8)
    n = 90
    src, dst = _edges(rng, n, 700)
    src[:20] = dst[:20]  # existing self-loops, replaced by prepare_graph
    w = rng.random(len(src)).astype(np.float32)
    j0 = jprepare_graph(src, dst, n, edge_weight=w, improved=improved, layouts=("bat",),
                        e_tile=TILES["e_tile"], s_tile=TILES["s_tile"])
    jg = jbuild_graph(np.asarray(j0.src), np.asarray(j0.dst), n,
                      edge_weight=np.asarray(j0.edge_weight), assume_sorted=True,
                      layouts=("bat",), **TILES)
    tg = prepare_graph(src, dst, n, edge_weight=w, improved=improved, device="cpu", **TILES)
    np.testing.assert_array_equal(np.asarray(jg.edge_weight), tg.edge_weight.numpy())
    x = rng.standard_normal((n, 12)).astype(np.float32)
    jm = JGCNConv(features=7, normalize=False, use_bias=False, backend="pallas")
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jg)
    j = jm.apply(params, jnp.asarray(x), jg)
    tm = GCNConv(12, 7, normalize=False, use_bias=False, device="cpu")
    kernel = np.asarray(params["params"]["Dense_0"]["kernel"])
    tm.lin.weight.data.copy_(torch.from_numpy(kernel.T.copy()))
    assert tm.bias is None
    with torch.inference_mode():
        t = tm(torch.from_numpy(x), tg)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL_PALLAS)


def _baked_pair(layouts=("bat", "stream")):
    """(JAX graph, port graph) over a community-structured graph with the
    GCN norm baked in and, with "stream", the hybrid plans built (off the
    tuning table's vetoed bucket: 1,024 nodes, ~25 k edges, average degree
    ~24)."""
    from geot_tpu.graph.datasets import synthetic_clustered_graph

    d = synthetic_clustered_graph(1024, 24_000, mixing=0.1, mean_community=256, seed=0)
    j0 = jprepare_graph(d.src, d.dst, 1024, normalize="gcn", layouts=("bat",),
                        e_tile=TILES["e_tile"], s_tile=TILES["s_tile"])
    jg = jbuild_graph(np.asarray(j0.src), np.asarray(j0.dst), 1024,
                      edge_weight=np.asarray(j0.edge_weight), assume_sorted=True,
                      layouts=layouts, **TILES)
    tg = prepare_graph(d.src, d.dst, 1024, normalize="gcn", layouts=layouts,
                       device="cpu", **TILES)
    np.testing.assert_allclose(np.asarray(jg.edge_weight), tg.edge_weight.numpy(),
                               rtol=1e-6, atol=1e-7)
    assert (jg.hyb is not None) == (tg.hyb is not None) == ("stream" in layouts)
    return jg, tg


def test_gcn_over_hybrid_graph_matches_jax():
    """GCN(conv_kwargs={"normalize": False}) over a graph whose norm was
    baked in by prepare_graph(normalize="gcn", layouts=("bat", "stream")):
    every layer's SpMM takes the hybrid path, in both packages."""
    from geot_tpu.ops.api import dispatch_path as jdispatch_path
    from geot_tpu_torch.ops.api import dispatch_path

    jg, tg = _baked_pair()
    assert dispatch_path(tg) == jdispatch_path(jg, backend="pallas") == "hybrid"
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1024, 24)).astype(np.float32)
    jm = JGCN(hidden_features=32, num_layers=3, out_features=7, backend="pallas",
              conv_kwargs={"normalize": False})
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x), jg)
    j = jm.apply(params, jnp.asarray(x), jg)
    tm = GCN(24, 32, 3, 7, conv_kwargs={"normalize": False}, device="cpu").eval()
    assert all(not c.normalize for c in tm.convs)
    tm.load_state_dict(params_from_flax(_flax_to_numpy(params)))
    with torch.inference_mode():
        t = tm(torch.from_numpy(x), tg)
    assert t.shape == (1024, 7) and torch.isfinite(t).all()
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL_PALLAS)


@pytest.mark.parametrize("path", ["bat", "hybrid"])
def test_gcn_bf16_matches_jax(path):
    """The compute dtype (flax `dtype`): bf16 products and activations,
    float32 sums in the SpMM, float32 parameters, over the BAT path and
    the hybrid path (the norm baked in, as the hybrid path needs).
    Tolerance: the bf16 budget of test_stream.py (rtol 0.05, atol 0.2),
    two layers."""
    from geot_tpu.ops.api import dispatch_path as jdispatch_path
    from geot_tpu_torch.ops.api import dispatch_path

    jg, tg = _baked_pair(("bat", "stream") if path == "hybrid" else ("bat",))
    want = "hybrid" if path == "hybrid" else "bat_static"
    assert dispatch_path(tg) == jdispatch_path(jg, backend="pallas") == want
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1024, 16)).astype(np.float32)
    kw = dict(conv_kwargs={"normalize": False})
    jm = JGCN(hidden_features=32, num_layers=2, out_features=5, backend="pallas",
              dtype=jnp.bfloat16, **kw)
    params = jm.init(jax.random.PRNGKey(4), jnp.asarray(x), jg)
    j = jm.apply(params, jnp.asarray(x), jg)
    assert j.dtype == jnp.bfloat16
    tm = GCN(16, 32, 2, 5, dtype=torch.bfloat16, device="cpu", **kw).eval()
    tm.load_state_dict(params_from_flax(_flax_to_numpy(params)))
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    with torch.inference_mode():
        t = tm(torch.from_numpy(x), tg)
    assert t.dtype == torch.bfloat16
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=0.05, atol=0.2)


def test_gcn_edge_weight_bf16_degree_sums_in_float32(monkeypatch):
    """In bf16 the port sums the degree in float32 and rounds the weights
    once; the reference sums the degree in bf16, which stalls at 256 on a
    hub (ROADMAP C.6). The port's bf16 weights are the reference's float32
    weights rounded to bf16."""
    from geot_tpu.models.conv import gcn_edge_weight as jgcn_edge_weight

    rng = np.random.default_rng(3)
    n = 300
    src, dst = _edges(rng, n, 2400)
    jg, tg = _pair(src, dst, n, None, monkeypatch, 1 << 30)
    t = gcn_edge_weight(tg, torch.bfloat16)
    assert t.dtype == torch.bfloat16
    j32 = np.asarray(jgcn_edge_weight(jg, jnp.float32))
    np.testing.assert_allclose(t.float().numpy(), j32, rtol=2 ** -8, atol=0)
    deg = np.bincount(tg.dst.numpy(), minlength=n)
    assert deg.max() > 256  # the hub the bf16 reference degree stalls on
    j16 = np.asarray(jgcn_edge_weight(jg, jnp.bfloat16), np.float32)
    hub_edges = tg.dst.numpy() == deg.argmax()
    assert np.abs(j16[hub_edges] - j32[hub_edges]).max() > 2 ** -8 * np.abs(j32).max()


def test_gcn_edge_weight_deterministic_mode(monkeypatch):
    """The degree is a sum in a fixed order with no atomics (ROADMAP C.3):
    it runs under torch.use_deterministic_algorithms(True), and with
    non-integer weights on a graph with a hub it matches the JAX function
    and reruns bit for bit."""
    from geot_tpu.models.conv import gcn_edge_weight as jgcn_edge_weight

    rng = np.random.default_rng(8)
    n = 200
    src, dst = _edges(rng, n, 3000)
    dst[:600] = 3  # a hub
    w = (rng.random(len(src)) + 0.05).astype(np.float32)
    jg0 = jprepare_graph(src, dst, n, edge_weight=w, layouts=("bat",),
                         e_tile=TILES["e_tile"], s_tile=TILES["s_tile"])
    tg = prepare_graph(src, dst, n, edge_weight=w, device="cpu", **TILES)
    np.testing.assert_array_equal(np.asarray(jg0.dst), tg.dst.numpy())
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        a, b = gcn_edge_weight(tg), gcn_edge_weight(tg)
    finally:
        torch.use_deterministic_algorithms(prev)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    np.testing.assert_allclose(a.numpy(), np.asarray(jgcn_edge_weight(jg0)),
                               rtol=1e-6, atol=1e-7)
    assert gcn_edge_weight(tg, torch.bfloat16).dtype == torch.bfloat16
