"""The port's host side against the JAX package: BAT plans, build_graph,
the synthetic generator and preprocessing. Plan arrays and meta must be
EQUAL, not close: the CUDA kernel and the Pallas kernel walk the same
tiles."""

import numpy as np
import pytest
import torch

from geot_tpu.graph import datasets as jds
from geot_tpu.graph import plan as jplan
from geot_tpu.graph import preprocess as jpre
from geot_tpu.graph.structures import build_graph as jbuild_graph
from geot_tpu_torch.graph import datasets as tds
from geot_tpu_torch.graph import plan as tplan
from geot_tpu_torch.graph import preprocess as tpre
from geot_tpu_torch.graph.structures import build_graph as tbuild_graph

META_KEYS = ("e_tile", "s_tile", "num_segments", "n_blocks", "num_edges",
             "n_vblocks", "km_pack", "chunks", "chunk_blocks", "chunk_vblocks")


def _hub_graph(rng, n, nnz, hub_edges=0, hub=3):
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** -1.0
    p /= p.sum()
    dst = np.concatenate([rng.choice(n, size=nnz, p=p),
                          np.full(hub_edges, hub)]).astype(np.int32)
    src = rng.integers(0, n, size=len(dst), dtype=np.int32)
    return src, dst


def _assert_host_equal(ja, jm, ta, tm):
    for k in ("out_block", "vblock", "dst3"):
        np.testing.assert_array_equal(np.asarray(ja[k]), np.asarray(ta[k]), err_msg=k)
        assert np.asarray(ja[k]).dtype == np.asarray(ta[k]).dtype, k
    for k in META_KEYS:
        assert jm[k] == tm[k], (k, jm[k], tm[k])


CASES = [
    # (n, nnz, hub_edges, num_segments_extra, e_tile, s_tile, max_chunk_tiles)
    (300, 2000, 0, 0, 64, 32, 8192),      # plain, unchunked
    (300, 2000, 900, 0, 64, 32, 8),       # hub window split across chunks
    (300, 2000, 0, 0, 128, 64, 5),        # many uniformized chunks
    (200, 150, 0, 4000, 32, 32, 8192),    # many empty windows (coverage tiles)
    (200, 150, 0, 4000, 32, 32, 7),       # empty windows + chunks
    (1000, 9000, 3000, 0, 256, 128, 12),  # wider tiles, hub, chunked
    (50, 0, 0, 0, 64, 32, 8192),          # no edges at all
]


@pytest.mark.parametrize("case", CASES)
def test_bat_plan_host_equal(case):
    n, nnz, hub, extra, e_tile, s_tile, mct = case
    rng = np.random.default_rng(sum(case))
    if nnz + hub:
        _, dst = _hub_graph(rng, n, nnz, hub)
        dst = np.sort(dst)
    else:
        dst = np.zeros(0, np.int32)
    num_seg = n + extra
    ja, jm = jplan.build_bat_plan_host(dst, num_seg, e_tile=e_tile, s_tile=s_tile,
                                       max_chunk_tiles=mct)
    ta, tm = tplan.build_bat_plan_host(dst, num_seg, e_tile=e_tile, s_tile=s_tile,
                                       max_chunk_tiles=mct)
    _assert_host_equal(ja, jm, ta, tm)
    if mct < 100 and nnz + hub:
        assert tm["chunks"], "case meant to be chunked"
    # the device plan carries the same arrays and the edge-row schedule of
    # its own tensors, one entry per edge (chunked or not)
    bp = tplan.bat_plan_from_host(ta, tm)
    np.testing.assert_array_equal(bp.vblock.numpy(), ta["vblock"])
    assert bp.row_sched is not None and bp.row_sched.matches(tplan._sched_key(bp))
    assert bp.row_sched.cols.shape[0] == len(dst)


def test_compute_chunks_equal_and_hub_split():
    rng = np.random.default_rng(61)
    n = 100
    dst = np.sort(np.concatenate([np.full(1500, 3, np.int32),
                                  rng.integers(0, n, 400).astype(np.int32)]))
    ja, _ = jplan.build_bat_plan_host(dst, n, e_tile=32, s_tile=32)
    for cap in (3, 8, 20):
        jc = jplan.compute_chunks(ja["out_block"], cap)
        tc = tplan.compute_chunks(ja["out_block"], cap)
        assert jc == tc
        # the hub window is cut mid-window: consecutive chunks share it
        assert any(b[2] < a[3] for a, b in zip(tc[:-1], tc[1:]))


def test_plan_rejects_unsorted_and_out_of_range():
    with pytest.raises(ValueError):
        tplan.build_bat_plan_host(np.array([3, 1, 2]), 10)
    with pytest.raises(ValueError):
        tplan.build_bat_plan_host(np.array([1, 2, 12]), 10)
    # packed plans build (they were refused before the packed kernel was
    # ported): k-major dst ids equal to the JAX package's; a km_pack that
    # does not divide e_tile is dropped, as there
    for km_pack, e_tile in ((4, 512), (3, 512)):
        ta, tm = tplan.build_bat_plan_host(np.array([1, 2]), 10, km_pack=km_pack,
                                           e_tile=e_tile)
        ja, jm = jplan.build_bat_plan_host(np.array([1, 2]), 10, km_pack=km_pack,
                                           e_tile=e_tile)
        assert sorted(ta) == sorted(ja) and tm["km_pack"] == jm["km_pack"]
        for k in ja:
            np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    assert tm["km_pack"] == 0 and "dst_km" not in ta


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("budget", [1 << 30, 64 * 1024])
def test_build_graph_equal(weighted, budget, monkeypatch):
    monkeypatch.setenv("GEOT_MAX_CHUNK_BYTES", str(budget))
    rng = np.random.default_rng(5)
    n = 400
    src, dst = _hub_graph(rng, n, 3000, 500)
    w = rng.standard_normal(len(src)).astype(np.float32) if weighted else None
    kw = dict(e_tile=64, s_tile=32, bat_e_tile=64, bat_s_tile=32, feature_hint=128)
    jg = jbuild_graph(src, dst, n, edge_weight=w, layouts=("bat",), **kw)
    tg = tbuild_graph(src, dst, n, edge_weight=w, max_chunk_bytes=budget, layouts=("bat",),
                      device="cpu", **kw)
    for k in ("src", "dst", "perm_t", "dst_t"):
        np.testing.assert_array_equal(np.asarray(getattr(jg, k)),
                                      getattr(tg, k).numpy(), err_msg=k)
    if weighted:
        np.testing.assert_array_equal(np.asarray(jg.edge_weight), tg.edge_weight.numpy())
        np.testing.assert_array_equal(np.asarray(jg.edge_weight_t),
                                      tg.edge_weight_t.numpy())
    else:
        assert tg.edge_weight is None and jg.edge_weight is None
    for name in ("bat", "bat_t"):
        jb, tb = getattr(jg, name), getattr(tg, name)
        for k in ("out_block", "vblock", "dst3"):
            np.testing.assert_array_equal(np.asarray(getattr(jb, k)),
                                          getattr(tb, k).numpy(), err_msg=f"{name}.{k}")
        for k in META_KEYS:
            assert getattr(jb, k) == getattr(tb, k), (name, k)
    if budget < (1 << 20):
        assert tg.bat.chunks, "small budget meant to chunk the plan"


def test_build_graph_rejects_unported_layouts():
    """The refusals that remain once the slot layout and its per-call
    weights are ported: ("bat", "slot") builds; per-call weights over a
    slot graph that prefers the slot layout for them (slot_dyn) now run
    and equal the plain path, with their gradients; narrow-feature BAT
    plans now build packed and equal the plain path; layouts outside
    LAYOUTS raise."""
    from geot_tpu_torch.ops import api as tapi
    from geot_tpu_torch.ops import reference as tref

    src = np.array([0, 1, 2, 2], np.int32)
    dst = np.array([1, 0, 0, 1], np.int32)
    g = tbuild_graph(src, dst, 3, layouts=("bat", "slot"), device="cpu")
    assert g.plan is not None and g.bat is not None and g.w_slots is None
    x = torch.ones(3, 4)
    torch.testing.assert_close(tapi.segment_spmm(g, x), torch.tensor([[2.0] * 4, [2.0] * 4,
                                                                      [0.0] * 4]))
    w = torch.tensor([0.5, -1.0, 2.0, 3.0])
    xr = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    gd = tbuild_graph(src, dst, 3, layouts=("slot",), prefer="sr", prefer_dyn="sr",
                      device="cpu")
    assert tapi.dispatch_path(gd, dynamic_w=True) == "slot_dyn"
    want = tref.gather_weight_scatter_ref(gd.src, gd.dst, w, xr, 3)
    ws = w.clone().requires_grad_()
    xs = xr.clone().requires_grad_()
    torch.testing.assert_close(tapi.segment_spmm(gd, xr, edge_weight=w), want)
    out = tapi.gather_weight_scatter(gd.src, gd.dst, ws, xs, 3, graph=gd)
    torch.testing.assert_close(out, want)
    out.sum().backward()
    wr = w.clone().requires_grad_()
    xrr = xr.clone().requires_grad_()
    tref.gather_weight_scatter_ref(gd.src, gd.dst, wr, xrr, 3).sum().backward()
    torch.testing.assert_close(ws.grad, wr.grad)
    torch.testing.assert_close(xs.grad, xrr.grad)
    # narrow-feature BAT plans build (refused before the packed kernel was
    # ported) and take the packed kernel: km_pack 128 // 32
    for layouts in (("bat",), ("bat", "slot")):
        gn = tbuild_graph(src, dst, 3, feature_hint=32, layouts=layouts, device="cpu")
        assert gn.bat.km_pack == gn.bat_t.km_pack == 4 and gn.bat.dst_km is not None
        torch.testing.assert_close(tapi.segment_spmm(gn, xr),
                                   tref.gather_scatter_ref(gn.src, gn.dst, xr, 3))
    with pytest.raises(NotImplementedError):
        tbuild_graph(src, dst, 3, layouts=("slot", "bat"), device="cpu")
    with pytest.raises(ValueError):
        tbuild_graph(src, dst, 3, layouts=("slot",), prefer="bat_packed", device="cpu")


def test_synthetic_graph_equal():
    n, e, f, c = 3000, 20000, 16, 5
    jd = jds.synthetic_graph(n, e, feat_dim=f, num_classes=c, seed=11)
    td = tds.synthetic_graph(n, e, feat_dim=f, num_classes=c, seed=11)
    for k in ("src", "dst", "x", "y", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(jd, k), getattr(td, k), err_msg=k)
    assert td.num_edges == jd.num_edges
    assert tds.DATASET_SHAPES["ogbn-arxiv"] == jds.DATASET_SHAPES["ogbn-arxiv"]


def test_preprocess_matches():
    rng = np.random.default_rng(3)
    n = 60
    src = rng.integers(0, n, 300).astype(np.int32)
    dst = rng.integers(0, n, 300).astype(np.int32)
    w = rng.random(300).astype(np.float32)
    js = jpre.sort_edges_by_dst(src, dst, w)
    ts = tpre.sort_edges_by_dst(src, dst, w)
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jl = jpre.add_self_loops(src, dst, n, w, fill_value=2.0)
    tl = tpre.add_self_loops(src, dst, n, w, fill_value=2.0)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(jpre.degree(dst, n)),
                                  tpre.degree(dst, n).numpy())
    jn = jpre.gcn_norm(src, dst, n, w)
    tn = tpre.gcn_norm(src, dst, n, w)
    np.testing.assert_array_equal(np.asarray(jn[0]), tn[0].numpy())
    np.testing.assert_array_equal(np.asarray(jn[1]), tn[1].numpy())
    np.testing.assert_allclose(np.asarray(jn[2]), tn[2].numpy(), rtol=1e-6, atol=1e-7)
    assert isinstance(tn[2], torch.Tensor)


def test_uniformized_pad_tiles_may_overlap_the_next_chunk():
    """The pad tiles of a uniformized chunk cover windows up to
    w0 + chunk_blocks, which may lie past the next chunk's first window:
    out_block is then non-decreasing only within each chunk. Such a plan
    (the JAX package builds and runs it) is accepted, and
    bat_segment_sum over the whole plan in one call (its schedule drops
    the pad tiles) equals the chunk-by-chunk plain sum and the reference.
    A (vblock, out_block) tile repeated across two chunks is refused when
    the plan is made."""
    import dataclasses

    from geot_tpu_torch.ops import reference as tref
    from geot_tpu_torch.ops.bat_kernels import bat_segment_sum, bat_segment_sum_plain

    rng = np.random.default_rng(5)
    n = 3000
    _, dst = _hub_graph(rng, n, 30000, 3000)
    dst = np.sort(dst)
    for cap in (40, 30, 20, 10):
        ja, jm = jplan.build_bat_plan_host(dst, n, e_tile=256, s_tile=64, max_chunk_tiles=cap)
        ob = ja["out_block"]
        if not np.all(ob[1:] >= ob[:-1]):
            break
    else:
        raise AssertionError("no cap gives pad tiles past the next chunk")
    ta, tm = tplan.build_bat_plan_host(dst, n, e_tile=256, s_tile=64, max_chunk_tiles=cap)
    _assert_host_equal(ja, jm, ta, tm)
    bp = tplan.bat_plan_from_host(ta, tm)
    vals = torch.from_numpy(rng.standard_normal((len(dst), 128)).astype(np.float32))
    whole = bat_segment_sum(bp, vals)
    by_chunk = torch.zeros_like(whole)
    for t0, t1, _, _ in tm["chunks"]:
        by_chunk += bat_segment_sum_plain(dataclasses.replace(
            bp, out_block=bp.out_block[t0:t1], vblock=bp.vblock[t0:t1]), vals)
    torch.testing.assert_close(whole, by_chunk, rtol=1e-4, atol=1e-4)
    exp = tref.segment_reduce_ref(vals, torch.from_numpy(dst), n)
    torch.testing.assert_close(whole[:n], exp, rtol=1e-4, atol=1e-4)
    assert not np.all(ob[1:] >= ob[:-1])
    # the schedule lists each edge once, the pad tiles' sentinel block none
    cols = bp.row_sched.cols.numpy().view(np.uint32) & 0x7FFFFFFF
    np.testing.assert_array_equal(np.sort(cols), np.arange(len(dst)))
    # the same real tile at the end of one chunk and the start of the next
    # (a split hub window): each chunk is in order, the plan is refused
    ch = tm["chunks"]
    a, b = next((a, b) for a, b in zip(ch[:-1], ch[1:]) if b[2] < a[3])
    vb = ta["vblock"]
    last_a = a[0] + int(np.nonzero(vb[a[0]:a[1]] < tm["n_vblocks"])[0][-1])
    assert ta["out_block"][last_a] == ta["out_block"][b[0]]
    vb2 = vb.copy()
    vb2[b[0]] = vb[last_a]
    with pytest.raises(ValueError, match=r"repeats a \(vblock, out_block\) tile"):
        tplan.bat_plan_from_host(dict(ta, vblock=vb2), tm)
