"""The port's parallel package against the JAX package's.

Mirrors `tests/test_parallel.py`. The same numpy edges go through both
packages' `partition_graph`: every array must be equal (bounds, halo
schedule, each layout's stacked plans, weights and families), for the
slot, BAT (multi-chunk: bat_e_tile 32, max_chunk_tiles 4) and hybrid
layouts at 2, 4 and 8 parts, with empty parts and the uneven 97-node split
of `test_multiprocess.py`. Each part's reduces on the port's CPU route
(the kernels' plain versions) are held in-process against JAX's, in
Pallas interpret mode and on its reference route. Then spawned gloo groups
of 2, 4 and 8 ranks (`spawn_ranks`, each running several cases per
spawn) run `halo_spmm` forward and x gradient, held to JAX's `halo_spmm`
on the 8-device CPU mesh at rtol/atol 1e-4 (the JAX tests' tolerance),
with the blocked pad rows exactly 0; and the exchange is started before
the interior reduce and waited for after it, in both directions.

Tolerance of the in-process reduces: rtol/atol 2e-4, the SpMM paths'
bound in ROADMAP (JAX's interpret-mode stream kernel selects rows under a
hi/lo bf16 split, ~2^-16 relative).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from geot_tpu.graph.datasets import synthetic_classification_graph as jcls_graph
from geot_tpu.models.conv import gcn_edge_weight as jgcn_edge_weight
from geot_tpu.models.conv import prepare_graph as jprepare_graph
from geot_tpu.parallel import block_nodes as jblock_nodes
from geot_tpu.parallel import halo_spmm as jhalo_spmm
from geot_tpu.parallel import node_sharding as jnode_sharding
from geot_tpu.parallel import partition_graph as jpartition_graph
from geot_tpu.parallel.bat_partition import part_bat_reduce as jpart_bat_reduce
from geot_tpu.parallel.halo_spmm import _local_reduce as jlocal_reduce
from geot_tpu.parallel.halo_spmm import _unbatch_plan as junbatch_plan
from geot_tpu.parallel.stream_partition import part_stream_reduce as jpart_stream_reduce
from geot_tpu_torch.parallel import block_nodes, node_sharding, partition_graph, spawn_ranks
from geot_tpu_torch.parallel.bat_partition import part_bat_reduce
from geot_tpu_torch.parallel.halo_spmm import part_slot_reduce
from geot_tpu_torch.parallel.stream_partition import part_stream_reduce
from torch_parallel_worker import exchange_order, halo_cases, mismatched_parts

TOL = dict(rtol=1e-4, atol=1e-4)
TOL_REDUCE = dict(rtol=2e-4, atol=2e-4)
SPAWN_TIMEOUT = 240.0


def _rand(seed, n_nodes=100, n_edges=600, f=16, weighted=True):
    """test_parallel.py's random graph."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    w = rng.standard_normal(n_edges).astype(np.float32) if weighted else None
    x = rng.standard_normal((n_nodes, f)).astype(np.float32)
    return src, dst, w, x


def _clustered_parts(n, P, intra, cross, seed=0):
    """test_parallel.py's part-aligned communities (the census streams)."""
    rng = np.random.default_rng(seed)
    npp = n // P
    p_of = rng.integers(0, P, intra)
    dst_i = p_of * npp + rng.integers(0, npp, intra)
    src_i = p_of * npp + rng.integers(0, npp, intra)
    dst_c = rng.integers(0, n, cross)
    src_c = rng.integers(0, n, cross)
    return (np.concatenate([src_i, src_c]).astype(np.int32),
            np.concatenate([dst_i, dst_c]).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _uneven97():
    """test_multiprocess.py's 97-node graph with self-loops and the GCN norm
    (JAX's `prepare_graph` and `gcn_edge_weight`): src, dst, w, data."""
    d = jcls_graph(97, 600, 4, feat_dim=8, seed=0)
    g = jprepare_graph(d.src, d.dst, d.num_nodes, add_self_loops=True, e_tile=32, s_tile=32)
    return np.asarray(g.src), np.asarray(g.dst), np.asarray(jgcn_edge_weight(g)), d


BAT_KW = dict(s_tile=32, layout="bat", bat_e_tile=32, max_chunk_tiles=4)
HYB_KW = dict(s_tile=32, layout="hybrid", bat_e_tile=256, max_chunk_tiles=8)


def _case(name, P):
    """(src, dst, num_nodes, w, x, partition keywords) of a named case."""
    if name in ("slot_w16", "slot_u100"):
        f, weighted = (16, True) if name == "slot_w16" else (100, False)
        src, dst, w, x = _rand(P, f=f, weighted=weighted)
        return src, dst, x.shape[0], w, x, dict(e_tile=64, s_tile=64)
    if name in ("bat_w", "bat_u"):
        weighted = name == "bat_w"
        src, dst, w, x = _rand(31, n_nodes=150, n_edges=900, f=16 if weighted else 8,
                               weighted=weighted)
        return src, dst, x.shape[0], w, x, BAT_KW
    if name == "hybrid":
        src, dst = _clustered_parts(512, P, 12_000, 1_200, seed=41)
        rng = np.random.default_rng(42)
        w = rng.standard_normal(len(src)).astype(np.float32)
        return src, dst, 512, w, rng.standard_normal((512, 16)).astype(np.float32), HYB_KW
    if name == "empty":  # every edge into node 0: the other parts have no edges
        rng = np.random.default_rng(3)
        src = rng.integers(0, 80, 200).astype(np.int32)
        dst = np.zeros(200, np.int32)
        return src, dst, 80, None, rng.standard_normal((80, 8)).astype(np.float32), dict(
            e_tile=32, s_tile=32)
    if name == "uneven97":
        src, dst, w, d = _uneven97()
        return src, dst, d.num_nodes, w, d.x.astype(np.float32), dict(e_tile=32, s_tile=32)
    raise KeyError(name)


HALO_CASES = {
    2: ("slot_w16", "slot_u100", "bat_w", "hybrid", "empty"),
    4: ("slot_w16", "bat_u", "hybrid", "empty", "uneven97"),
    8: ("hybrid", "uneven97"),
}
BACKENDS = ("auto", "reference")


def _cot(name, P, n, f):
    return np.random.default_rng(1000 + P).standard_normal((n, f)).astype(np.float32)


# ---------------------------------------------------------------- arrays equal


def _equal(a, b, what):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _same_partition(jp, tp):
    for k in ("num_parts", "nodes_per_part", "halo", "part_start", "num_nodes",
              "padded_nodes"):
        assert getattr(jp, k) == getattr(tp, k), k
    _equal(jp.send_idx, tp.send_idx, "send_idx")
    _equal(jp.send_mask, tp.send_mask, "send_mask")
    for k in ("plan", "plan_t", "plan_int", "plan_int_t"):
        a, b = getattr(jp, k), getattr(tp, k)
        assert (a is None) == (b is None), k
        if a is None:
            continue
        for f in ("src_slots", "dst_slots", "edge_pos", "mask", "out_block"):
            _equal(getattr(a, f), getattr(b, f), f"{k}.{f}")
        for f in ("e_tile", "s_tile", "num_segments", "n_blocks", "num_edges",
                  "num_src_nodes"):
            assert getattr(a, f) == getattr(b, f), (k, f)
    for k in ("w_slots", "w_slots_t", "w_int", "w_int_t"):
        a, b = getattr(jp, k), getattr(tp, k)
        assert (a is None) == (b is None), k
        if a is not None:
            _equal(a, b, k)
    for k in ("bat", "bat_t", "bat_int", "bat_int_t", "stream_int", "stream_int_t"):
        a, b = getattr(jp, k), getattr(tp, k)
        assert (a is None) == (b is None), k
        if a is None:
            continue
        for fld in a.__dataclass_fields__.values():
            va, vb = getattr(a, fld.name), getattr(b, fld.name)
            if fld.metadata.get("static"):
                assert va == vb, (k, fld.name, va, vb)
            elif va is None:
                assert vb is None, (k, fld.name)
            else:
                _equal(va, vb, f"{k}.{fld.name}")


@pytest.mark.parametrize("nparts", [2, 4, 8])
@pytest.mark.parametrize("layout", ["slot", "bat", "hybrid"])
def test_partition_arrays_equal(layout, nparts):
    if layout == "hybrid":
        src, dst, n, w, _, kw = _case("hybrid", nparts)
    else:
        src, dst, n, w, _, kw = _case("slot_w16" if layout == "slot" else "bat_w", nparts)
    jp = jpartition_graph(src, dst, n, nparts, edge_weight=w, **kw)
    tp = partition_graph(src, dst, n, nparts, edge_weight=w, **kw)
    assert tp.layout == layout
    if layout == "bat":
        # the tiny budget forces several chunks
        assert max(f.C for f in (tp.bat, tp.bat_t, tp.bat_int, tp.bat_int_t)) >= 2
    if layout == "hybrid":
        assert tp.stream_int is not None
    _same_partition(jp, tp)
    for r in range(nparts):  # every part's view builds (the schedules check the plans)
        tp.part(r, "cpu")


@pytest.mark.parametrize("nparts", [2, 4])
@pytest.mark.parametrize("layout", ["slot", "bat", "hybrid"])
def test_partition_arrays_equal_empty_parts(layout, nparts):
    src, dst, n, _, _, kw = _case("empty", nparts)
    if layout != "slot":
        kw = dict(BAT_KW, layout=layout)
    jp = jpartition_graph(src, dst, n, nparts, **kw)
    tp = partition_graph(src, dst, n, nparts, **kw)
    _same_partition(jp, tp)
    edges_per_part = np.diff(np.searchsorted(np.sort(dst), tp.part_start))
    assert list(edges_per_part) == [200] + [0] * (nparts - 1)
    for r in range(nparts):
        tp.part(r, "cpu")


@pytest.mark.parametrize("layout", ["slot", "bat"])
def test_partition_arrays_equal_uneven97(layout):
    src, dst, n, w, _, kw = _case("uneven97", 8)
    if layout == "bat":
        kw = BAT_KW
    jp = jpartition_graph(src, dst, n, 8, edge_weight=w, **kw)
    tp = partition_graph(src, dst, n, 8, edge_weight=w, **kw)
    assert len(set(np.diff(tp.part_start))) > 1  # the parts' widths differ
    _same_partition(jp, tp)


def test_partition_auto_and_unweighted():
    """layout='auto' picks the slot layout at these sizes and BAT past the
    1 GiB gather (the reference's TPU pick); unweighted families."""
    src, dst, w, x = _rand(35, n_nodes=80, n_edges=400)
    for kw in (dict(), dict(feature_hint=1 << 26, max_chunk_tiles=4)):
        jp = jpartition_graph(src, dst, 80, 4, **kw)
        tp = partition_graph(src, dst, 80, 4, **kw)
        _same_partition(jp, tp)
    assert tp.layout == "bat"
    with pytest.raises(ValueError, match="layout"):
        partition_graph(src, dst, 80, 4, layout="stream")


# ------------------------------------------------------ each part's reduces


def _part_of(tree, r):
    return jax.tree_util.tree_map(lambda a: a[r:r + 1], tree)


@pytest.mark.parametrize("layout,nparts", [("slot", 2), ("bat", 2), ("bat", 4), ("hybrid", 2)])
def test_part_reduces_vs_jax(layout, nparts):
    """Every part's four reduces (boundary and interior, both directions)
    and, in the hybrid layout, its streamed cells, on the port's CPU route
    against JAX's Pallas kernels in interpret mode and its reference
    route, at F 16 (sr_packed) and, for the slot layout, 100 (sr)."""
    name = {"slot": "slot_w16", "bat": "bat_w", "hybrid": "hybrid"}[layout]
    src, dst, n, w, _, kw = _case(name, nparts)
    jp = jpartition_graph(src, dst, n, nparts, edge_weight=w, **kw)
    tp = partition_graph(src, dst, n, nparts, edge_weight=w, **kw)
    rows = {"boundary": nparts * tp.halo, "interior": tp.nodes_per_part,
            "boundary_t": tp.nodes_per_part, "interior_t": tp.nodes_per_part}
    rng = np.random.default_rng(7)
    streamed = 0
    for r in range(nparts):
        view = tp.part(r, "cpu")
        for F in (16, 100) if layout == "slot" else (16,):
            for fam, (jplan, jw, jbat) in {
                "boundary": (jp.plan, jp.w_slots, jp.bat),
                "interior": (jp.plan_int, jp.w_int, jp.bat_int),
                "boundary_t": (jp.plan_t, jp.w_slots_t, jp.bat_t),
                "interior_t": (jp.plan_int_t, jp.w_int_t, jp.bat_int_t),
            }.items():
                xr = rng.standard_normal((rows[fam], F)).astype(np.float32)
                xt = torch.from_numpy(xr)
                if layout == "slot":
                    got = part_slot_reduce(getattr(view, fam), xt)
                    got_r = part_slot_reduce(getattr(view, fam), xt, "reference")
                    jpl = junbatch_plan(_part_of(jplan, r))
                    want = [jlocal_reduce(jpl, jnp.asarray(xr), jw[r], u) for u in (True, False)]
                else:
                    got = part_bat_reduce(getattr(view, fam), xt)
                    got_r = part_bat_reduce(getattr(view, fam), xt, "reference")
                    jf = _part_of(jbat, r).unbatch()
                    want = [jpart_bat_reduce(jf, jnp.asarray(xr), u) for u in (True, False)]
                for label, g in (("plain route", got), ("reference route", got_r)):
                    for jlabel, j in zip(("pallas", "jax reference"), want):
                        np.testing.assert_allclose(
                            g.numpy(), np.asarray(j), **TOL_REDUCE,
                            err_msg=f"part {r} {fam} F={F}: {label} vs {jlabel}")
        if layout == "hybrid":
            for sp, jfam in ((view.stream, jp.stream_int), (view.stream_t, jp.stream_int_t)):
                xr = rng.standard_normal((tp.nodes_per_part, 16)).astype(np.float32)
                want = np.asarray(jpart_stream_reduce(_part_of(jfam, r).unbatch(),
                                                      jnp.asarray(xr)))
                if sp is None:  # the part streams nothing: all its tiles are pads
                    assert not (np.asarray(jfam.dst3[r]) >= 0).any() and not want.any()
                    continue
                streamed += 1
                xt = torch.from_numpy(xr)
                carry = torch.randn(sp.n_blocks * sp.s_tile, 16,
                                    generator=torch.Generator().manual_seed(r))
                for backend in BACKENDS:
                    got = part_stream_reduce(sp, xt, backend)[: tp.nodes_per_part]
                    np.testing.assert_allclose(got.numpy(), want, **TOL_REDUCE)
                    acc = part_stream_reduce(sp, xt, backend, carry=carry.clone())
                    np.testing.assert_allclose((acc - carry)[: tp.nodes_per_part].numpy(),
                                               want, **TOL_REDUCE)
    assert layout != "hybrid" or streamed


def test_part_view_schedules_skip_pads():
    """A part's BAT plan keeps the equalized chunks, its pad tiles read the
    shared sentinel block past the plan, and its row schedule lists only
    the part's live edges (no row at or past n_blocks * s_tile)."""
    src, dst, n, w, _, kw = _case("bat_w", 4)
    tp = partition_graph(src, dst, n, 4, edge_weight=w, **kw)
    fam = tp.bat_int
    for r in range(4):
        pb = fam.unbatch(r, "cpu")
        bp = pb.plan
        assert bp.n_vblocks == fam.n_vblocks and len(bp.chunks) == fam.C
        assert [c[1] - c[0] for c in bp.chunks] == [fam.T_c] * fam.C
        n_live = int((fam.dst3[r] >= 0).sum())
        sched = bp.row_sched
        assert sched.cols.shape[0] == n_live and sched.n_out == bp.n_blocks * bp.s_tile
        pad = bp.vblock == fam.n_vblocks
        assert bool((bp.out_block[pad] <= bp.n_blocks).all())
    hyb = partition_graph(*_case("hybrid", 4)[:2], 512, 4, **HYB_KW)
    for r in range(4):
        sp = hyb.part(r, "cpu").stream
        assert sp is not None and bool((sp.out_block[1:] >= sp.out_block[:-1]).all())
        assert int((sp.dst3 >= 0).sum()) == int((hyb.stream_int.dst3[r] >= 0).sum())


# ------------------------------------------------ halo_spmm in gloo groups


@functools.lru_cache(maxsize=None)
def _mesh(P):
    devs = jax.devices()
    if len(devs) < P:
        pytest.skip(f"needs {P} devices, have {len(devs)}")
    return Mesh(np.array(devs[:P]), ("parts",))


@functools.lru_cache(maxsize=None)
def _jax_halo(name, P):
    """JAX's halo_spmm forward and x gradient (blocked) of a case."""
    src, dst, n, w, x, kw = _case(name, P)
    pg = jpartition_graph(src, dst, n, P, edge_weight=w, **kw)
    mesh = _mesh(P)
    xp = jax.device_put(jblock_nodes(jnp.asarray(x), pg), jnode_sharding(mesh))
    cot = jax.device_put(jblock_nodes(jnp.asarray(_cot(name, P, n, x.shape[1])), pg),
                         jnode_sharding(mesh))

    def both(xx, cc):
        out, vjp = jax.vjp(lambda z: jhalo_spmm(z, pg, mesh, backend="reference"), xx)
        return out, vjp(cc)[0]

    out, grad = jax.jit(both)(xp, cot)
    return np.asarray(out), np.asarray(grad), pg


@functools.lru_cache(maxsize=None)
def _port_halo(P):
    """One spawn of P gloo ranks running every case of HALO_CASES[P] on
    both backends: {(case, backend): (blocked out, blocked grad)}."""
    cases = []
    for name in HALO_CASES[P]:
        src, dst, n, w, x, kw = _case(name, P)
        cases.append(dict(name=name, src=src, dst=dst, num_nodes=n, w=w, x=x, kw=kw,
                          cot=_cot(name, P, n, x.shape[1]), backends=BACKENDS))
    per_rank = spawn_ranks(halo_cases, P, cases, timeout=SPAWN_TIMEOUT)
    return {key: tuple(np.concatenate([res[key][i] for res in per_rank]) for i in (0, 1))
            for key in per_rank[0]}


HALO_PARAMS = [(P, name, b) for P, names in HALO_CASES.items() for name in names
               for b in BACKENDS]


@pytest.mark.parametrize("P,name,backend", HALO_PARAMS)
def test_halo_spmm_forward_vs_jax(P, name, backend):
    out, _ = _port_halo(P)[(name, backend)]
    want, _, pg = _jax_halo(name, P)
    np.testing.assert_allclose(out, want, **TOL)
    from geot_tpu.parallel.halo_spmm import _block_index

    _, valid = _block_index(pg)
    assert np.all(out[~valid] == 0)  # the blocked pad rows receive nothing


@pytest.mark.parametrize("P,name,backend", HALO_PARAMS)
def test_halo_spmm_grad_vs_jax(P, name, backend):
    _, grad = _port_halo(P)[(name, backend)]
    _, want, _ = _jax_halo(name, P)
    np.testing.assert_allclose(grad, want, **TOL)


def test_interior_reduce_between_exchange_start_and_wait():
    """The counterpart of test_interior_reduce_independent_of_exchange:
    each rank starts the all-to-all, runs the interior reduce (which reads
    only the local block), then waits and runs the boundary reduce; the
    backward starts the reverse exchange after the boundary transpose and
    runs the interior transpose before its wait. In every layout."""
    cases = []
    for name in ("slot_w16", "bat_w", "hybrid"):
        src, dst, n, w, x, kw = _case(name, 2)
        cases.append(dict(name=name, src=src, dst=dst, num_nodes=n, w=w, x=x, kw=kw))
    for per_rank in spawn_ranks(exchange_order, 2, cases, timeout=SPAWN_TIMEOUT):
        for name, (fwd, bwd) in per_rank.items():
            assert fwd == ["start", "_interior_reduce", "wait", "_boundary_reduce"], (name, fwd)
            assert bwd == ["_boundary_reduce_t", "start", "_interior_reduce", "wait",
                           "_send_back"], (name, bwd)


def test_group_size_must_match_parts():
    """A view of a P-part partition in a group of another size raises, and
    so does a view of another rank or an x of the wrong rows."""
    src, dst, n, w, x, kw = _case("slot_w16", 2)
    case = dict(src=src, dst=dst, num_nodes=n, w=w, kw=kw)
    with pytest.raises(RuntimeError, match="the group has 2 ranks, the partition 3 parts"):
        spawn_ranks(mismatched_parts, 2, case, timeout=SPAWN_TIMEOUT)
    tp = partition_graph(src, dst, n, 2, edge_weight=w, **kw)
    assert node_sharding(tp, 1) == slice(tp.nodes_per_part, 2 * tp.nodes_per_part)
    xb = block_nodes(torch.from_numpy(x), tp)
    assert xb.shape == (tp.padded_nodes, x.shape[1])

