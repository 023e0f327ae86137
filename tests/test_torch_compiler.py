"""The port's compiler pass against the JAX package's.

Mirrors tests/test_compiler.py. Each user function is written once in jnp
and once in torch over the same seeded numpy inputs and the same graph
(`prepare_graph` in both packages: the same dst-sorted edges). The JAX
function goes through `geot_tpu.compiler.pattern_transform(...,
backend="reference")`, the torch one through the port's pass on the CPU
(the fused ops run their plain versions there): both count the same
matches, and the outputs agree to rtol/atol 2e-4 (tests/test_ops.py's
SpMM bound: f32 sums of the same terms in other orders). The gradients of
the rewritten torch function are held against the unrewritten one's and
against `jax.vjp` of the JAX pass at the same tolerance, and a second
call with the same shapes does not trace again.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geot_tpu.compiler import count_matches as jcount
from geot_tpu.compiler import pattern_transform as jtransform
from geot_tpu.models import prepare_graph as jprepare
from geot_tpu_torch.compiler import count_matches, pattern_transform
from geot_tpu_torch.compiler import match_replace as tmr
from geot_tpu_torch.models import prepare_graph

TOL = dict(rtol=2e-4, atol=2e-4)


def _graphs(seed=0, n=80, e=400):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    kw = dict(add_self_loops=False, e_tile=64, s_tile=64)
    jg = jprepare(src, dst, n, **kw)
    tg = prepare_graph(src, dst, n, device="cpu", **kw)
    np.testing.assert_array_equal(np.asarray(jg.src), tg.src.numpy())
    np.testing.assert_array_equal(np.asarray(jg.dst), tg.dst.numpy())
    return jg, tg, rng


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a)).requires_grad_(grad)


def _check(jfn, tfn, jg, tg, args, n_matches):
    """Both passes match n_matches sites; the rewritten outputs agree; the
    rewritten torch function's gradients equal the unrewritten one's."""
    jargs = [jnp.asarray(a) for a in args]
    targs = [_t(a, grad=True) for a in args]
    assert jcount(jfn, jg, *jargs) == n_matches
    assert count_matches(tfn, tg, *targs) == n_matches
    want = jtransform(jfn, jg, backend="reference")(*jargs)
    fused = pattern_transform(tfn, tg)
    out = fused(*targs)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jfn(*jargs)), **TOL)
    cot_np = np.random.default_rng(9).standard_normal(out.shape).astype(np.float32)
    cot = torch.from_numpy(cot_np)
    got = torch.autograd.grad((out * cot).sum(), targs)
    plain = torch.autograd.grad((tfn(*targs) * cot).sum(), targs)
    _, vjp = jax.vjp(jtransform(jfn, jg, backend="reference"), *jargs)
    for a, b, j in zip(got, plain, vjp(jnp.asarray(cot_np))):
        torch.testing.assert_close(a, b, **TOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(j), **TOL)
    (gm, sites), = fused.cache.values()
    assert sites == n_matches
    return fused, gm


def test_rewrites_weighted_scatter():
    jg, tg, rng = _graphs(0)
    n = tg.num_nodes
    x = rng.standard_normal((n, 16), dtype=np.float32)
    w = rng.standard_normal(tg.num_edges).astype(np.float32)
    js, jd, ts, td = jg.src, jg.dst, tg.src, tg.dst

    def jfn(x, w):
        return jnp.zeros((n, x.shape[1]), x.dtype).at[jd].add(x[js] * w[:, None])

    def tfn(x, w):
        msg = x.index_select(0, ts) * w[:, None]
        return torch.zeros(n, x.shape[1]).index_add_(0, td, msg)

    _, gm = _check(jfn, tfn, jg, tg, (x, w), 1)
    code = gm.code
    assert "geot_fused_gws" in code and "index_select" not in code and "index_add" not in code


def test_nonzero_scatter_base_preserved():
    """`x.index_add(0, dst, x[src])`: the scatter's base is added back."""
    jg, tg, rng = _graphs(7)
    n = tg.num_nodes
    x = rng.standard_normal((n, 16), dtype=np.float32)
    js, jd, ts, td = jg.src, jg.dst, tg.src, tg.dst
    _check(lambda x: x.at[jd].add(x[js]), lambda x: x.index_add(0, td, x[ts]), jg, tg, (x,), 1)


@pytest.mark.parametrize("form", ["index_add", "scatter_add"])
def test_rewrites_unweighted_segment_sum(form):
    jg, tg, rng = _graphs(1)
    n = tg.num_nodes
    x = rng.standard_normal((n, 8), dtype=np.float32)
    js, jd, ts, td = jg.src, jg.dst, tg.src, tg.dst

    def jfn(x):
        return jax.ops.segment_sum(x[js], jd, n, indices_are_sorted=True)

    def tfn(x):
        msg = x[ts]
        if form == "index_add":
            return x.new_zeros(n, 8).index_add_(0, td, msg)
        idx = td.long().unsqueeze(1).expand_as(msg)
        return torch.zeros_like(x).scatter_add_(0, idx, msg)

    _check(jfn, tfn, jg, tg, (x,), 1)


def test_rewrites_multihead():
    jg, tg, rng = _graphs(2)
    n, H, D = tg.num_nodes, 4, 8
    x = rng.standard_normal((n, H, D), dtype=np.float32)
    w = rng.standard_normal((tg.num_edges, H)).astype(np.float32)
    js, jd, ts, td = jg.src, jg.dst, tg.src, tg.dst

    def jfn(x, w):
        return jnp.zeros((n, H, D), x.dtype).at[jd].add(x[js] * w[:, :, None])

    def tfn(x, w):
        return torch.zeros(n, H, D).index_add_(0, td, x[ts] * w.unsqueeze(-1))

    _, gm = _check(jfn, tfn, jg, tg, (x, w), 1)
    assert "geot_fused_mh" in gm.code


def test_two_layer_model_and_cached_second_call(monkeypatch):
    """Both layers' aggregations are rewritten; the second call with the
    same shapes runs the cached module (no trace), a new shape traces once
    more."""
    jg, tg, rng = _graphs(3)
    n = tg.num_nodes
    js, jd, ts, td = jg.src, jg.dst, tg.src, tg.dst
    w1 = (rng.standard_normal((16, 32), dtype=np.float32) * 0.1)
    w2 = (rng.standard_normal((32, 4), dtype=np.float32) * 0.1)
    x = rng.standard_normal((n, 16), dtype=np.float32)

    def jmodel(x, w1, w2):
        h = jax.ops.segment_sum((x @ w1)[js], jd, n, indices_are_sorted=True)
        h = jax.nn.relu(h) @ w2
        return jax.ops.segment_sum(h[js], jd, n, indices_are_sorted=True)

    def tmodel(x, w1, w2):
        h = x @ w1
        h = torch.zeros(n, h.shape[1]).index_add_(0, td, h[ts])
        h = torch.relu(h) @ w2
        return torch.zeros(n, h.shape[1]).index_add_(0, td, h[ts])

    fused, _ = _check(jmodel, tmodel, jg, tg, (x, w1, w2), 2)
    traces = []
    real = tmr._trace
    monkeypatch.setattr(tmr, "_trace", lambda *a: traces.append(1) or real(*a))
    args = [_t(a) for a in (x, w1, w2)]
    again = fused(*args)
    assert traces == [] and len(fused.cache) == 1
    np.testing.assert_allclose(again.numpy(), np.asarray(jmodel(x, w1, w2)), **TOL)
    fused(args[0][:, :8].contiguous(), args[1][:8].contiguous(), args[2])
    assert traces == [1] and len(fused.cache) == 2


def test_no_match_left_untouched():
    """Scatters of another row or edge count, a weight per feature and a
    scatter along another axis evaluate unchanged."""
    jg, tg, rng = _graphs(4)
    n, e = tg.num_nodes, tg.num_edges
    x = rng.standard_normal((50, 8), dtype=np.float32)
    idx = rng.integers(0, 50, 50).astype(np.int32)

    def jfn(x):
        return jnp.zeros((50, 8), x.dtype).at[idx].add(x)

    def tfn(x):
        return torch.zeros(50, 8).index_add_(0, torch.from_numpy(idx), x)

    _check(jfn, tfn, jg, tg, (x,), 0)
    xf = rng.standard_normal((n, 8), dtype=np.float32)
    wf = rng.standard_normal((e, 8)).astype(np.float32)
    ts, td = tg.src, tg.dst

    def per_feature(x, w):
        return torch.zeros(n, 8).index_add_(0, td, x[ts] * w)

    def other_axis(x):
        return torch.zeros(8, n).index_add_(1, td, x[ts].t())

    for fn, args in ((per_feature, (xf, wf)), (other_axis, (xf,))):
        targs = [_t(a) for a in args]
        assert count_matches(fn, tg, *targs) == 0
        torch.testing.assert_close(pattern_transform(fn, tg)(*targs), fn(*targs), rtol=0, atol=0)


@pytest.mark.parametrize("form", ["transposed", "other_edges"])
def test_same_shapes_other_indices_left_untouched(form):
    """Shapes do not decide a match: the transposed message pattern
    x[dst] -> src (the backward direction) and another edge list of the
    graph's size are left as they are, and evaluate unchanged."""
    jg, tg, rng = _graphs(5)
    n, e = tg.num_nodes, tg.num_edges
    x = rng.standard_normal((n, 8), dtype=np.float32)
    w = rng.standard_normal(e).astype(np.float32)
    if form == "transposed":
        sidx, gidx = tg.src, tg.dst
    else:
        gidx = torch.from_numpy(rng.integers(0, n, e).astype(np.int32))
        sidx = torch.from_numpy(np.sort(rng.integers(0, n, e)).astype(np.int32))

    def fn(x, w):
        return torch.zeros(n, 8).index_add_(0, sidx, x.index_select(0, gidx) * w[:, None])

    targs = [_t(a) for a in (x, w)]
    assert count_matches(fn, tg, *targs) == 0
    torch.testing.assert_close(pattern_transform(fn, tg)(*targs), fn(*targs), rtol=0, atol=0)


def test_index_arguments_guard_the_cached_rewrite(monkeypatch):
    """Indices passed as arguments: the graph's rewrite, cached; the same
    values in another tensor reuse it; other values of the same shape
    (the transposed edges) trace again and are left alone."""
    jg, tg, rng = _graphs(6)
    n = tg.num_nodes
    x = _t(rng.standard_normal((n, 8), dtype=np.float32))

    def fn(x, src, dst):
        return torch.zeros(n, 8).index_add_(0, dst, x[src])

    fused = pattern_transform(fn, tg)
    want = np.zeros((n, 8), np.float32)
    np.add.at(want, tg.dst.numpy(), x.numpy()[tg.src.numpy()])
    np.testing.assert_allclose(fused(x, tg.src, tg.dst).numpy(), want, **TOL)
    (gm, sites), = fused.cache.values()
    assert sites == 1 and "geot_fused_gs" in gm.code
    traces = []
    real = tmr._trace
    monkeypatch.setattr(tmr, "_trace", lambda *a: traces.append(1) or real(*a))
    np.testing.assert_allclose(fused(x, tg.src.clone(), tg.dst.clone()).numpy(), want, **TOL)
    assert traces == []
    out = fused(x, tg.dst, tg.src)
    torch.testing.assert_close(out, fn(x, tg.dst, tg.src), rtol=0, atol=0)
    (gm, sites), = fused.cache.values()
    assert traces == [1] and sites == 0
