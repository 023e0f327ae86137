"""The edge softmax (`ops.softmax_kernels`): its plain version, the CPU path
of `edge_softmax` and `edge_softmax_grad`, against the JAX package and the
plain `segment_softmax_ref`, through both entry points (GAT's per-node
terms, `segment_softmax`'s per-edge logits).

The graph has an empty row, a hub row of 1,500 edges (longer than the
card's 256-edge chunks, so the kernel cuts it into pieces) and one
pre-activation exactly 0. Held in float64 (JAX under `jax.enable_x64`) to
1e-12: the two packages compute the same sums in another order. At the
0 pre-activation the port takes torch's LeakyReLU rule (the slope, as
`F.leaky_relu`'s backward); `jax.nn.leaky_relu` takes 1 there, so the JAX
side writes the same function as `where(x > 0, x, slope * x)`. The GAT
route as a whole (float32, with the mh aggregation) is held against JAX's
`gat_attention_spmm` to the tolerances of `test_torch_mh.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from geot_tpu.models.conv import prepare_graph as jprepare_graph
from geot_tpu.ops import api as japi
from geot_tpu_torch.models import prepare_graph
from geot_tpu_torch.ops import api as tapi
from geot_tpu_torch.ops import reference as tref
from geot_tpu_torch.ops.softmax_kernels import edge_softmax, edge_softmax_grad

SLOPE = 0.2
TOL64 = dict(rtol=1e-12, atol=1e-12)
TOL_GAT = dict(rtol=1e-4, atol=1e-4)
TOL_GAT_GRAD = dict(rtol=1e-3, atol=1e-4)


def _edges(rng, n=300, hub=7, hub_edges=1500, nnz=2500):
    """dst-sorted (src, dst) with a hub row and no edge into nodes 250.."""
    dst = np.sort(np.concatenate([np.full(hub_edges, hub),
                                  rng.integers(0, 250, nnz)])).astype(np.int32)
    src = rng.integers(0, n, len(dst)).astype(np.int32)
    return src, dst, n


def _graph(rng):
    src, dst, n = _edges(rng)
    g = prepare_graph(src, dst, n, add_self_loops=False, layouts=("slot",), e_tile=64,
                      s_tile=64, device="cpu")
    return g, src, dst, n


def _terms(rng, g, n, H):
    """alpha_src, alpha_dst [n, H] float64, one edge's pre-activation exactly 0."""
    a_s = 0.7 * rng.standard_normal((n, H))
    a_d = 0.7 * rng.standard_normal((n, H))
    k = int(g.dst_ptr[7]) + 3  # an edge of the hub row
    s, d = int(g.src[k]), int(g.dst[k])
    a_s[s, 0] = -a_d[d, 0]
    assert a_s[s, 0] + a_d[d, 0] == 0.0
    return a_s, a_d, k


def _leaky(x):
    return jnp.where(x > 0, x, SLOPE * x)


def test_graph_runs():
    """dst_ptr and src_ptr: the runs of dst and of src in src-sorted order
    (src[perm_t]), as numpy makes them."""
    g, src, dst, n = _graph(np.random.default_rng(0))
    order = np.argsort(src, kind="stable")
    assert g.dst_ptr.dtype == torch.int32 and g.src_ptr.dtype == torch.int32
    np.testing.assert_array_equal(g.dst_ptr.numpy(), np.searchsorted(dst, np.arange(n + 1)))
    np.testing.assert_array_equal(g.src_ptr.numpy(),
                                  np.searchsorted(src[order], np.arange(n + 1)))
    np.testing.assert_array_equal(g.perm_t.numpy(), order)
    assert int(g.dst_ptr[251]) == int(g.dst_ptr[-1])  # rows 250.. are empty


@pytest.mark.parametrize("H", [1, 3, 8])
@pytest.mark.parametrize("entry", ["node_terms", "logits"])
def test_edge_softmax_plain_matches_jax(H, entry):
    """`edge_softmax` and `edge_softmax_grad` on the CPU in float64 against
    JAX's composition (`segment_softmax` of the logits) and its vjp, and
    against `segment_softmax_ref` with torch autograd through
    `F.leaky_relu`."""
    rng = np.random.default_rng(10 * H + (entry == "logits"))
    g, src, dst, n = _graph(rng)
    E = g.num_edges
    a_s, a_d, k = _terms(rng, g, n, H)
    lg = 2.0 * rng.standard_normal((E, H))
    cot = rng.standard_normal((E, H))
    node = entry == "node_terms"

    def jatt(*args):
        lo = _leaky(args[0][src] + args[1][dst]) if node else args[0]
        return japi.segment_softmax(lo, jnp.asarray(dst), n)

    with jax.enable_x64(True):
        jin = (jnp.asarray(a_s), jnp.asarray(a_d)) if node else (jnp.asarray(lg),)
        jout, vjp = jax.vjp(jatt, *jin)
        jgrads = [np.asarray(x) for x in vjp(jnp.asarray(cot))]
        jout = np.asarray(jout)
        assert jout.dtype == np.float64

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    kw = dict(alpha_src=t(a_s), alpha_dst=t(a_d), src=g.src) if node else {}
    att = edge_softmax(g.dst, g.dst_ptr, None if node else t(lg), **kw)
    assert att.dtype == torch.float64 and att.shape == (E, H)
    np.testing.assert_allclose(att.numpy(), jout, **TOL64)
    grads = edge_softmax_grad(g.dst, g.dst_ptr, att, t(cot), **kw, perm_t=g.perm_t,
                              src_t=g.src.index_select(0, g.perm_t.long()),
                              src_ptr=g.src_ptr)
    grads = list(grads) if node else [grads]
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got.numpy(), want, **TOL64)
    rows = torch.zeros(n, H, dtype=torch.float64).index_add_(0, g.dst.long(), att)
    live = torch.diff(g.dst_ptr) > 0
    assert not bool(live[250:].any())
    np.testing.assert_allclose(rows[live].numpy(), 1.0, rtol=0, atol=1e-12)
    assert float(rows[~live].abs().max()) == 0.0

    # the plain reference, with torch's own autograd through F.leaky_relu
    ins = [t(a).requires_grad_() for a in ((a_s, a_d) if node else (lg,))]
    lo = F.leaky_relu(ins[0][g.src.long()] + ins[1][g.dst.long()], SLOPE) if node else ins[0]
    ref = tref.segment_softmax_ref(lo, g.dst, n)
    np.testing.assert_allclose(att.numpy(), ref.detach().numpy(), **TOL64)
    torch.autograd.backward(ref, t(cot))
    for got, x in zip(grads, ins):
        np.testing.assert_allclose(got.numpy(), x.grad.numpy(), **TOL64)
    if node:
        # the 0 pre-activation takes the slope: dalpha_dst's hub row sums
        # gl * slope there, not gl (jax.nn.leaky_relu's rule)
        x = t(a_s)[g.src.long()] + t(a_d)[g.dst.long()]
        assert float(x[k, 0]) == 0.0


@pytest.mark.parametrize("H", [0, 1, 3, 8])
def test_segment_softmax_float64_matches_jax(H):
    """The public `segment_softmax` (per-edge logits through the edge
    softmax's autograd) in float64, [nnz] (H 0) or [nnz, H], sorted and
    unsorted, forward and gradient against JAX's in float64."""
    rng = np.random.default_rng(40 + H)
    src, dst, n = _edges(rng)
    shape = (len(dst),) if H == 0 else (len(dst), H)
    lg = 3.0 * rng.standard_normal(shape)
    cot = rng.standard_normal(shape)
    with jax.enable_x64(True):
        jf = lambda x: japi.segment_softmax(x, jnp.asarray(dst), n)  # noqa: E731
        jout, vjp = jax.vjp(jf, jnp.asarray(lg))
        (jg,) = vjp(jnp.asarray(cot))
        jout, jg = np.asarray(jout), np.asarray(jg)
    x = torch.from_numpy(lg).requires_grad_()
    out = tapi.segment_softmax(x, torch.from_numpy(dst), n)
    assert out.dtype == torch.float64 and out.shape == shape
    np.testing.assert_allclose(out.detach().numpy(), jout, **TOL64)
    torch.autograd.backward(out, torch.from_numpy(cot))
    np.testing.assert_allclose(x.grad.numpy(), jg, **TOL64)
    perm = rng.permutation(len(dst))
    u = tapi.segment_softmax(torch.from_numpy(lg[perm]), torch.from_numpy(dst[perm]), n,
                             indices_are_sorted=False)
    np.testing.assert_allclose(u.numpy(), jout[perm], **TOL64)


@pytest.mark.parametrize("H", [1, 3, 8])
def test_gat_attention_spmm_hub_and_empty_rows_match_jax(H):
    """`gat_attention_spmm` on the CPU (the edge softmax's plain path, then
    mh over the slot plans) over the hub row and the empty rows, forward and
    the three gradients in float32, against JAX's fused route and its
    edge-order composition."""
    rng = np.random.default_rng(70 + H)
    src, dst, n = _edges(rng)
    D = 4
    jg = jprepare_graph(src, dst, n, add_self_loops=False, e_tile=64, s_tile=64)
    tg = prepare_graph(src, dst, n, add_self_loops=False, layouts=("slot",), e_tile=64,
                       s_tile=64, device="cpu")
    xh = rng.standard_normal((n, H, D)).astype(np.float32)
    a_s = (0.5 * rng.standard_normal((n, H))).astype(np.float32)
    a_d = (0.5 * rng.standard_normal((n, H))).astype(np.float32)
    co = rng.standard_normal((n, H, D)).astype(np.float32)
    ins = [jnp.asarray(a) for a in (xh, a_s, a_d)]

    def jfused(*a):
        return jnp.vdot(japi.gat_attention_spmm(jg, *a, backend="pallas"), jnp.asarray(co))

    j = np.asarray(japi.gat_attention_spmm(jg, *ins, backend="pallas"))
    jgr = jax.grad(jfused, argnums=(0, 1, 2))(*ins)
    args = [torch.from_numpy(a).requires_grad_() for a in (xh, a_s, a_d)]
    out = tapi.gat_attention_spmm(tg, *args)
    np.testing.assert_allclose(out.detach().numpy(), j, **TOL_GAT)
    assert float(out.detach()[250:].abs().max()) == 0.0
    torch.vdot(out.reshape(-1), torch.from_numpy(co).reshape(-1)).backward()
    for a, b in zip(args, jgr):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), **TOL_GAT_GRAD)
    # reruns give the same bits (every sum in a fixed order)
    again = [torch.from_numpy(a).requires_grad_() for a in (xh, a_s, a_d)]
    out2 = tapi.gat_attention_spmm(tg, *again)
    torch.vdot(out2.reshape(-1), torch.from_numpy(co).reshape(-1)).backward()
    assert torch.equal(out2, out)
    for a, b in zip(again, args):
        assert torch.equal(a.grad, b.grad)


def test_edge_softmax_refuses_other_devices():
    g, _, _, n = _graph(np.random.default_rng(5))
    with pytest.raises(ValueError, match="unsupported device"):
        edge_softmax(g.dst.to("meta"), g.dst_ptr.to("meta"), torch.empty(g.num_edges, 1,
                                                                          device="meta"))
