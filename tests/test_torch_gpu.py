"""The CUDA kernels on the card against their plain versions.

Marked `gpu`; each test skips without a card (decided inside the fixture,
so every pytest worker collects the same tests). The machine with the card
has no JAX, so this file imports none, and it is run there without the
suite's conftest (which sets JAX up):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerance: the kernel sums each row in edge order in f32, the plain
version with `index_add_` (atomics on the card, so any order): f32 sums of
the same terms in two orders, rows of up to ~1500 terms of magnitude ~1,
so rtol/atol 1e-4 (the reference's own hub-split bound, test_ops.py:362).
The SDDMM kernel (`sddmm_bat`, `edge_dots`) sums each head's products
lane-wise then by a segmented shuffle scan, the plain version with `sum`:
f32 sums of the same 7-256 products in two orders, held to 1e-4 *
sum|a_i b_i| + 1e-5 (the rule of `chip_smoke.py`). The pr kernel sums each
row's slots by the same scan over a warp's lanes, slices in order: the
rule of the slot kernels below. The
stream kernel sums each row in slot order, the plain version with
`index_add_`: the same rule. With bfloat16 x both read the same bf16
values and sum in f32, so the rule holds there too. The slot kernels sum
each row in slot order, the plain versions with `index_add_`: the same
rule, and so does the packed BAT kernel (edge order within a tile, tiles
in order).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from geot_tpu_torch.graph import plan as tplan
from geot_tpu_torch.graph import stream_plan as tsp
from geot_tpu_torch.graph.structures import build_graph
from geot_tpu_torch.models import GCN
from geot_tpu_torch.ops import api
from geot_tpu_torch.ops.bat_kernels import (
    bat_segment_sum,
    bat_segment_sum_packed,
    bat_segment_sum_plain,
    bucketed_sum,
    bucketed_sum_plain,
)
from geot_tpu_torch.ops import reference as tref
from geot_tpu_torch.ops import slot_kernels as tslot
from geot_tpu_torch.ops.sddmm_kernels import (
    edge_dots,
    edge_dots_plain,
    sddmm_bat,
    sddmm_bat_plain,
)
from geot_tpu_torch.ops.stream_kernels import (
    stream_segment_acc,
    stream_segment_acc_plain,
    stream_segment_sum,
    stream_segment_sum_plain,
)

pytestmark = pytest.mark.gpu
TOL_HUB = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _hubby(rng, n, nnz, hub_edges, hub=7):
    dst = np.concatenate([np.full(hub_edges, hub, np.int32),
                          rng.integers(0, n, nnz).astype(np.int32)])
    src = rng.integers(0, n, len(dst)).astype(np.int32)
    return src, dst


@pytest.mark.parametrize("f_pad", [128, 256, 100, 47])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("e_tile,s_tile", [(64, 32), (1024, 256), (32, 4), (96, 8), (32, 1)])
@pytest.mark.parametrize("form", ["values", "gathered"])
def test_kernel_matches_plain(cuda, f_pad, weighted, e_tile, s_tile, form):
    """The wide BAT sum (the edge-row kernel over the plan's schedule) at
    any width, in edge-order values or reading x[src[e]] itself."""
    rng = np.random.default_rng(f_pad + weighted + e_tile)
    n = 700
    src, dst = _hubby(rng, n, 5000, 1500)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    nnz = len(dst)
    bp = tplan.build_bat_plan(dst, n + 300, e_tile=e_tile, s_tile=s_tile, device=cuda)
    x = torch.from_numpy(rng.standard_normal((n, f_pad)).astype(np.float32)).to(cuda)
    s = torch.from_numpy(src).to(cuda) if form == "gathered" else None
    vals = x if s is not None else x.index_select(0, torch.from_numpy(src).long().to(cuda))
    w = (torch.from_numpy(rng.standard_normal(nnz).astype(np.float32)).to(cuda)
         if weighted else None)
    # leave NaN in the memory the caching allocator hands out next, so a
    # row the kernel fails to write shows
    torch.full((bp.n_blocks * s_tile + 4 * bp.num_tiles, f_pad), float("nan"), device=cuda)
    before = bat_segment_sum.launches
    k = bat_segment_sum(bp, vals, w, src=s)
    torch.cuda.synchronize()
    assert bat_segment_sum.launches == before + 1
    p = bat_segment_sum_plain(bp, vals, w, src=s)
    assert k.shape == p.shape == (bp.n_blocks * s_tile, f_pad)
    torch.testing.assert_close(k, p, **TOL_HUB)
    # deterministic: no atomics, bit-identical rerun
    torch.testing.assert_close(bat_segment_sum(bp, vals, w, src=s), k, rtol=0, atol=0)


def test_segment_spmm_chunked_hub_on_card(cuda):
    rng = np.random.default_rng(61)
    n, F = 100, 40
    src, dst = _hubby(rng, n, 400, 1500, hub=3)
    w = rng.standard_normal(len(dst)).astype(np.float32)
    kw = dict(bat_e_tile=32, bat_s_tile=32, max_chunk_bytes=8 * 32 * 128 * 4, layouts=("bat",))
    gc = build_graph(src, dst, n, edge_weight=w, device=cuda, **kw)
    gh = build_graph(src, dst, n, edge_weight=w, device="cpu", **kw)
    assert len(gc.bat.chunks) > 2
    x = rng.standard_normal((n, F)).astype(np.float32)
    before = bat_segment_sum.launches
    with torch.inference_mode():
        out = api.segment_spmm(gc, torch.from_numpy(x).to(cuda))
        exp = api.segment_spmm(gh, torch.from_numpy(x))
    assert bat_segment_sum.launches == before + 1  # the plan whole
    torch.testing.assert_close(out.cpu(), exp, **TOL_HUB)
    ch = tplan.compute_chunks(gh.bat.out_block.numpy(), 8)
    g2 = dataclasses.replace(gc, bat=tplan.with_chunks(gc.bat, ch))
    with torch.inference_mode():
        out2 = api.segment_spmm(g2, torch.from_numpy(x).to(cuda))
    torch.testing.assert_close(out2, out, rtol=0, atol=0)


def test_kernel_sums_uniformized_plan_whole(cuda):
    """A uniformized chunked plan whose pad tiles run past the next
    chunk's first window is not ordered as a whole; its schedule leaves
    the pad tiles out and lists each edge once in row order, so the
    kernel sums it whole in one launch, bit-identical to the unchunked
    plan."""
    rng = np.random.default_rng(5)
    n = 3000
    src, dst = _hubby(rng, n, 30000, 3000, hub=3)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    for cap in range(3, 80):
        bp = tplan.build_bat_plan(dst, n, e_tile=256, s_tile=64, max_chunk_tiles=cap,
                                  device=cuda)
        ob = bp.out_block.cpu()
        if bool((ob[1:] < ob[:-1]).any()):
            break
    else:
        raise AssertionError("no cap gives pad tiles past the next chunk")
    whole = tplan.build_bat_plan(dst, n, e_tile=256, s_tile=64, device=cuda)
    x = torch.from_numpy(rng.standard_normal((n, 128)).astype(np.float32)).to(cuda)
    s = torch.from_numpy(src).to(cuda)
    before = bat_segment_sum.launches
    out = bat_segment_sum(bp, x, src=s)
    torch.cuda.synchronize()
    assert bat_segment_sum.launches == before + 1
    assert torch.equal(out, bat_segment_sum(whole, x, src=s))
    exp = torch.zeros(n, 128, device=cuda).index_add_(0, torch.from_numpy(dst).long().to(cuda),
                                                      x.index_select(0, s.long()))
    torch.testing.assert_close(out[:n], exp, **TOL_HUB)


def test_gcn_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(5)
    n = 2000
    src = rng.integers(0, n, 16000).astype(np.int32)
    dst = rng.integers(0, n, 16000).astype(np.int32)
    x = torch.from_numpy(rng.standard_normal((n, 128)).astype(np.float32))
    from geot_tpu_torch.models import prepare_graph

    gc = prepare_graph(src, dst, n, device=cuda)
    gh = prepare_graph(src, dst, n, device="cpu")
    mc = GCN(128, 128, 3, 40, generator=torch.Generator().manual_seed(0), device=cuda).eval()
    mh = GCN(128, 128, 3, 40, generator=torch.Generator().manual_seed(0), device="cpu").eval()
    with torch.inference_mode():
        oc = mc(x.to(cuda), gc)
        oh = mh(x, gh)
    torch.testing.assert_close(oc.cpu(), oh, rtol=1e-4, atol=1e-4)


def _chunked_plan_past_n_blocks(dst, n, e_tile, s_tile, device):
    """A uniformized chunked plan one of whose pad tiles points past
    n_blocks (the a rows there are chunk-margin pad rows)."""
    for cap in range(3, 64):
        bp = tplan.build_bat_plan(dst, n, e_tile=e_tile, s_tile=s_tile,
                                  max_chunk_tiles=cap, device=device)
        if bp.chunks and int(bp.out_block.max()) >= bp.n_blocks:
            return bp
    raise AssertionError("no chunk cap puts a pad tile past n_blocks")


def _sddmm_inputs(bp, rng, f_pad, cuda, ragged):
    rows_a = (bp.n_blocks + (bp.chunk_blocks if bp.chunks else 0)) * bp.s_tile
    rows_b = bp.num_edges if ragged else bp.n_vblocks * bp.e_tile
    a = torch.from_numpy(rng.standard_normal((rows_a, f_pad)).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.standard_normal((rows_b, f_pad)).astype(np.float32)).to(cuda)
    return a, b


@pytest.mark.parametrize("f_pad", [128, 256])
@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_sddmm_kernel_matches_plain(cuda, f_pad, chunked, ragged):
    rng = np.random.default_rng(f_pad + 2 * chunked + ragged)
    n = 700
    _, dst = _hubby(rng, n, 5000, 1500)
    dst = np.sort(dst)
    if chunked:
        bp = _chunked_plan_past_n_blocks(dst, n, 64, 32, cuda)
    else:
        bp = tplan.build_bat_plan(dst, n, e_tile=64, s_tile=32, device=cuda)
    a, b = _sddmm_inputs(bp, rng, f_pad, cuda, ragged)
    # NaN in the memory the allocator hands out next: an unwritten or
    # wrongly read slot shows
    torch.full(((bp.n_vblocks + 1) * bp.e_tile,), float("nan"), device=cuda)
    before = sddmm_bat.launches
    k = sddmm_bat(bp, a, b, f_tile=256 if f_pad == 256 else 128)
    torch.cuda.synchronize()
    assert sddmm_bat.launches == before + 1
    p = sddmm_bat_plain(bp, a, b)
    lim = 1e-4 * sddmm_bat_plain(bp, a.abs(), b.abs()) + 1e-5
    assert k.shape == p.shape == ((bp.n_vblocks + 1) * bp.e_tile,)
    assert torch.isfinite(k).all()
    assert bool(((k - p).abs() <= lim).all()), float((k - p).abs().max())
    assert bool((k[bp.num_edges:] == 0).all())


def test_sddmm_kernel_deterministic(cuda):
    rng = np.random.default_rng(3)
    n = 700
    _, dst = _hubby(rng, n, 5000, 1500)
    bp = tplan.build_bat_plan(np.sort(dst), n, e_tile=1024, s_tile=256, device=cuda)
    a, b = _sddmm_inputs(bp, rng, 128, cuda, False)
    k = sddmm_bat(bp, a, b)
    for _ in range(3):
        torch.testing.assert_close(sddmm_bat(bp, a, b), k, rtol=0, atol=0)


@pytest.mark.parametrize("needs", ["both", "w_only"])
def test_gws_grad_kernel_vs_reference(cuda, needs):
    """The gradient of gather_weight_scatter from the kernel path (dx over
    the transpose plan, dw from sddmm_bat) against the reference backend's
    autograd, on a hubby graph whose chunks split a hub window. `w_only`
    is the case where only the weights need a gradient: the kernel path
    must still give one."""
    rng = np.random.default_rng(11)
    n, F = 300, 48
    src, dst = _hubby(rng, n, 3000, 1500, hub=3)
    g = build_graph(src, dst, n, bat_e_tile=64, bat_s_tile=32,
                    max_chunk_bytes=8 * 64 * 128 * 4, layouts=("bat",), device=cuda)
    assert len(g.bat.chunks) > 2
    x0 = torch.from_numpy(rng.standard_normal((n, F)).astype(np.float32)).to(cuda)
    w0 = torch.from_numpy(rng.standard_normal(g.num_edges).astype(np.float32)).to(cuda)
    cot = torch.from_numpy(rng.standard_normal((n, F)).astype(np.float32)).to(cuda)

    def grads(backend):
        x = x0.clone().requires_grad_(needs == "both")
        w = w0.clone().requires_grad_()
        out = api.gather_weight_scatter(g.src, g.dst, w, x, n, graph=g, backend=backend)
        torch.vdot(out.reshape(-1), cot.reshape(-1)).backward()
        return x.grad, w.grad

    before = (sddmm_bat.launches, bat_segment_sum.launches)
    dx, dw = grads("auto")
    torch.cuda.synchronize()
    n_fwd = 1  # each plan whole, chunked or not
    n_bwd = 1 if needs == "both" else 0
    assert sddmm_bat.launches == before[0] + 1
    assert bat_segment_sum.launches == before[1] + n_fwd + n_bwd
    dx_r, dw_r = grads("reference")
    assert dw is not None
    torch.testing.assert_close(dw, dw_r, rtol=1e-4, atol=1e-4)
    if needs == "both":
        torch.testing.assert_close(dx, dx_r, **TOL_HUB)
    else:
        assert dx is None


def _stream_edges(rng, n, hub_window_cells=12, cells=30, epc=1500, s_tile=256,
                  x_rows=256):
    """dst-sorted edges: `cells` dense (window, block) cells of `epc` edges,
    `hub_window_cells` of them in window 0 (a window the kernel splits
    over several blocks), one hub node in window 0, one 4,000-edge cell in
    the last window (a family of larger tiles), and uniform noise."""
    n_w, n_b = max(n // s_tile, 1), max(n // x_rows, 1)
    cw = np.concatenate([np.zeros(hub_window_cells, np.int64),
                         rng.integers(1, n_w - 1, cells - hub_window_cells)])
    cb = rng.integers(0, n_b, cells)
    dst = (cw[:, None] * s_tile + rng.integers(0, s_tile, (cells, epc))).reshape(-1)
    src = (cb[:, None] * x_rows + rng.integers(0, x_rows, (cells, epc))).reshape(-1)
    big_w, big_b = (n_w - 1) * s_tile, (n_b - 1) * x_rows
    dst = np.concatenate([dst, np.full(3000, 5), rng.integers(0, n, 3000),
                          big_w + rng.integers(0, s_tile, 4000)])
    src = np.concatenate([src, rng.integers(0, x_rows, 3000), rng.integers(0, n, 3000),
                          big_b + rng.integers(0, x_rows, 4000)])
    dst, src = np.minimum(dst, n - 1), np.minimum(src, n - 1)
    order = np.argsort(dst, kind="stable")
    return src[order].astype(np.int32), dst[order].astype(np.int32)


def _families(rng, cuda, weighted, e_tile=0, s_tile=256, x_rows=256, n=3000, schedule=None):
    src, dst = _stream_edges(rng, n, s_tile=s_tile, x_rows=x_rows)
    w = None
    if weighted:  # every fifth weight exactly 0: zero terms inside the rows' runs
        w = rng.standard_normal(len(src)).astype(np.float32)
        w[::5] = 0.0
    # a forced tile size gets a cost model under which every dense cell streams
    knobs = (tsp.StreamKnobs(min_stream_frac=0.05, tile_ns=(), fixed_ns=1.0, marg_ns=1.0)
             if e_tile else tsp.StreamKnobs(min_stream_frac=0.05))
    fams, _, _ = tsp.build_stream_split_host(
        dst, src, n, n, s_tile=s_tile, x_rows=x_rows, e_tile=e_tile, edge_weight=w,
        max_chunk_tiles=16, knobs=knobs, uniformize=True)
    assert fams is not None
    return [tsp.stream_plan_from_host(a, m, device=cuda, **(schedule or {})) for a, m in fams]


def _check_abs_sum(k, p, a):
    lim = 1e-4 * a + 1e-5
    assert torch.isfinite(k).all()
    assert bool(((k - p).abs() <= lim).all()), float((k - p).abs().max())


@pytest.mark.parametrize("mode", ["acc", "sum"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("F,dtype", [(128, torch.float32), (47, torch.float32),
                                     (256, torch.float32), (128, torch.bfloat16),
                                     (47, torch.bfloat16), (64, torch.float32),
                                     (32, torch.float32), (16, torch.float32),
                                     (16, torch.bfloat16), (8, torch.float32)])
@pytest.mark.parametrize("tiles", ["auto", "e100_s64_x128", "short_slices"])
def test_stream_kernels_match_plain(cuda, mode, weighted, F, dtype, tiles):
    """F 64, 32, 16 and 8 take the narrow lane groups (16, 8, 4 and 4 lanes);
    `short_slices` cuts every row past 16 live slots and adds the slices
    4 at a time, so the hub node's row goes through a tree of fix-up
    levels."""
    rng = np.random.default_rng(F + weighted + (mode == "acc"))
    kw = {"auto": {}, "e100_s64_x128": dict(e_tile=100, s_tile=64, x_rows=128),
          "short_slices": dict(schedule=dict(slice_slots=16, fix_fanin=4, task_cost=128))}
    sps = _families(rng, cuda, weighted, **kw[tiles])
    # the hub node's row (3,000 edges in window 0) is cut into slices
    assert any(sp.n_parts > 0 for sp in sps), "no row cut into slices"
    if tiles == "short_slices":
        assert max(len(sp.fix_levels) - 1 for sp in sps) >= 3, "no tree of fix-up levels"
    # window 0's 18,000 edges are spread over several groups' tasks
    assert any(sp.tasks.shape[0] - 1 > sp.out_block.unique().numel() for sp in sps)
    n = 3000
    # x rows end mid-block: the kernel reads the missing rows as zero
    x = torch.from_numpy(rng.standard_normal((n, F)).astype(np.float32)).to(cuda).to(dtype)
    fn = stream_segment_acc if mode == "acc" else stream_segment_sum
    for sp in sps:
        rows = sp.n_blocks * sp.s_tile
        carry0 = torch.from_numpy(rng.standard_normal((rows, F)).astype(np.float32)).to(cuda)
        # NaN in the memory the allocator hands out next: an unwritten row shows
        torch.full((rows + 64, max(F, 128)), float("nan"), device=cuda)
        before = fn.launches
        if mode == "acc":
            k = stream_segment_acc(sp, x, carry0.clone())
            p = stream_segment_acc_plain(sp, x, carry0.clone())
            a = stream_segment_acc_plain(
                dataclasses.replace(sp, w3=None if sp.w3 is None else sp.w3.abs()),
                x.abs(), carry0.abs())
        else:
            k = stream_segment_sum(sp, x)
            p = stream_segment_sum_plain(sp, x)
            a = stream_segment_sum_plain(
                dataclasses.replace(sp, w3=None if sp.w3 is None else sp.w3.abs()), x.abs())
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert k.shape == p.shape == (rows, F) and k.dtype == torch.float32
        _check_abs_sum(k, p, a)
        # no atomics: reruns are bit-identical
        again = (stream_segment_acc(sp, x, carry0.clone()) if mode == "acc"
                 else stream_segment_sum(sp, x))
        torch.testing.assert_close(again, k, rtol=0, atol=0)


def test_stream_plan_out_of_order_refused(cuda):
    """The kernel sums each window's tiles as one run, so a family whose
    out_block goes back is refused when the plan is made."""
    rng = np.random.default_rng(2)
    src, dst = _stream_edges(rng, 3000)
    fams, _, _ = tsp.build_stream_split_host(dst, src, 3000, 3000,
                                             knobs=tsp.StreamKnobs(min_stream_frac=0.05))
    arrays, meta = max(fams, key=lambda f: len(np.unique(f[0]["out_block"])))
    bad = dict(arrays, out_block=arrays["out_block"][::-1].copy())
    with pytest.raises(ValueError, match="non-decreasing"):
        tsp.stream_plan_from_host(bad, meta, device=cuda)


def _hybrid_graph(device, weighted=True, n=3000):
    rng = np.random.default_rng(9)
    src, dst = _stream_edges(rng, n)
    w = (rng.random(len(src)) + 0.1).astype(np.float32) if weighted else None
    return build_graph(src, dst, n, edge_weight=w, feature_hint=128,
                       layouts=("bat", "stream"), device=device), rng


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hybrid_segment_spmm_on_card_matches_cpu(cuda, dtype):
    gc, rng = _hybrid_graph(cuda)
    gh, _ = _hybrid_graph("cpu")
    assert api.dispatch_path(gc) == "hybrid"
    x = torch.from_numpy(rng.standard_normal((gc.num_nodes, 100)).astype(np.float32))
    xc = x.to(cuda).to(dtype).requires_grad_()
    xh = x.to(dtype).requires_grad_()
    before = (stream_segment_sum.launches, stream_segment_acc.launches)
    oc = api.segment_spmm(gc, xc)
    assert oc.dtype == dtype
    n_fam = len(gc.hyb.stream)
    assert stream_segment_sum.launches == before[0] + 1
    assert stream_segment_acc.launches == before[1] + n_fam - 1
    oh = api.segment_spmm(gh, xh)
    tol = TOL_HUB if dtype == torch.float32 else dict(rtol=2 ** -7, atol=2 ** -7)
    torch.testing.assert_close(oc.float().cpu(), oh.float(), **tol)
    cot = torch.from_numpy(rng.standard_normal(tuple(oc.shape)).astype(np.float32))
    (oc.float() * cot.to(cuda)).sum().backward()
    (oh.float() * cot).sum().backward()
    assert xc.grad.dtype == dtype
    torch.testing.assert_close(xc.grad.float().cpu(), xh.grad.float(), **tol)


def test_gcn_edge_weight_deterministic_on_card(cuda):
    """The degree of gcn_edge_weight sums in a fixed order with no atomics
    (ROADMAP C.3): with non-integer weights on a graph with a 20,000-edge
    hub, reruns under torch.use_deterministic_algorithms(True) are bit
    for bit the same."""
    from geot_tpu_torch.models import gcn_edge_weight

    rng = np.random.default_rng(4)
    n = 5000
    dst = np.concatenate([np.full(20000, 17), rng.integers(0, n, 60000)]).astype(np.int32)
    src = rng.integers(0, n, len(dst)).astype(np.int32)
    w = (rng.random(len(dst)) + 0.01).astype(np.float32)
    g = build_graph(src, dst, n, edge_weight=w, layouts=("bat",), device=cuda)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        first = gcn_edge_weight(g)
        for _ in range(5):
            torch.testing.assert_close(gcn_edge_weight(g), first, rtol=0, atol=0)
    finally:
        torch.use_deterministic_algorithms(prev)
    gh = build_graph(src, dst, n, edge_weight=w, layouts=("bat",), device="cpu")
    torch.testing.assert_close(first.cpu(), gcn_edge_weight(gh), rtol=1e-6, atol=1e-7)


def test_bf16_fused_ops_over_bat_on_card(cuda):
    """bfloat16 in, bfloat16 out, float32 sums over the BAT path on the
    card (ROADMAP C.2): the kernel's wrapper no longer sees bf16."""
    rng = np.random.default_rng(8)
    n, F = 700, 96
    src, dst = _hubby(rng, n, 5000, 1500)
    w = (rng.random(len(dst)) + 0.1).astype(np.float32)
    kw = dict(bat_e_tile=64, bat_s_tile=32, layouts=("bat",))
    gc = build_graph(src, dst, n, edge_weight=w, device=cuda, **kw)
    gh = build_graph(src, dst, n, edge_weight=w, device="cpu", **kw)
    x = torch.from_numpy(rng.standard_normal((n, F)).astype(np.float32)).bfloat16()
    tol = dict(rtol=2 ** -7, atol=2 ** -7)
    for op in (
        lambda g, xx: api.segment_spmm(g, xx),
        lambda g, xx: api.gather_scatter(g.src, g.dst, xx, n, graph=g),
        lambda g, xx: api.gather_weight_scatter(g.src, g.dst, g.edge_weight, xx, n, graph=g),
        lambda g, xx: api.index_scatter(xx[g.src.long()], g.dst, n, plan=g.bat),
    ):
        oc = op(gc, x.to(cuda))
        assert oc.dtype == torch.bfloat16
        torch.testing.assert_close(oc.float().cpu(), op(gh, x).float(), **tol)


def _assert_abs_sum(k, p, a):
    """|kernel - plain| <= 1e-4 * sum|terms| + 1e-5 per element."""
    assert k.shape == p.shape and bool(torch.isfinite(k).all())
    bad = (k - p).abs() > 1e-4 * a + 1e-5
    assert not bool(bad.any()), f"{int(bad.sum())} elements over, max err {(k - p).abs().max()}"


def _edge_order(plan, slot_rows):
    """The edge-order copy [nnz, ...] of slot-ordered rows (real slots)."""
    real = plan.mask.reshape(-1) > 0
    out = torch.zeros((plan.num_edges,) + tuple(slot_rows.shape[1:]), dtype=slot_rows.dtype,
                      device=slot_rows.device)
    out[plan.edge_pos.reshape(-1)[real].long()] = slot_rows[: real.numel()][real]
    return out


def _two_heads(plan, w):
    """[T*E, 2] head weights from slot weights w: head 0 is w, head 1 is
    0.5 on every other real slot, so a slot of w 0 is zero on one head only
    or on both."""
    odd = (torch.arange(w.numel(), device=w.device) % 2 == 1).reshape(w.shape)
    h1 = torch.where(odd, torch.zeros_like(w), 0.5 * plan.mask)
    return torch.stack([w.reshape(-1), h1.reshape(-1)], dim=1).contiguous()


def _aeb_pair(kernel):
    """(kernel, plain) of an AEB or mh kernel as fn(plan, slot_vals, w):
    `sr2` slot values with per-call weights w in edge order; `sr2_edge`
    edge-order values with static slot weights w; `packed2` edge-order
    values with per-call weights; `mh` two heads (`_two_heads`)."""
    def make(sr2, packed2, mh):
        def run(plan, v, w):
            if kernel == "sr2":
                return sr2(plan, v, w_edge=_edge_order(plan, w.reshape(-1)))
            if kernel == "sr2_edge":
                return sr2(plan, _edge_order(plan, v), vals_layout="edge", w_slots=w)
            if kernel == "packed2":
                return packed2(plan, _edge_order(plan, v), w_edge=_edge_order(plan, w.reshape(-1)))
            return mh(plan, v, _two_heads(plan, w), v.shape[1] // 2)
        return run

    return (make(tslot.plan_segment_sum_sr2, tslot.plan_segment_sum_packed2,
                 tslot.plan_segment_sum_mh),
            make(tref.plan_segment_sum_sr2_plain, tref.plan_segment_sum_packed2_plain,
                 tref.plan_segment_sum_mh_plain))


_SLOT = {
    "sr": (tslot.plan_segment_sum_sr, tref.plan_segment_sum_sr_plain),
    "sr_packed": (tslot.plan_segment_sum_sr_packed, tref.plan_segment_sum_sr_packed_plain),
    "pr": (tslot.plan_segment_sum_pr, tref.plan_segment_sum_pr_plain),
    **{k: _aeb_pair(k) for k in ("sr2", "sr2_edge", "packed2", "mh")},
}


@pytest.mark.parametrize("kernel,F", [("sr", 500), ("sr", 128), ("sr", 100), ("sr", 7),
                                      ("sr_packed", 64), ("sr_packed", 32),
                                      ("sr_packed", 16), ("sr_packed", 8), ("sr_packed", 7),
                                      ("sr_packed", 1), ("pr", 8), ("pr", 3), ("pr", 100)])
@pytest.mark.parametrize("tiles", [(512, 256, 1), (64, 32, 16), (96, 128, 1), (32, 1, 1)])
@pytest.mark.parametrize("weighted", [False, True])
def test_slot_kernels_match_plain(cuda, kernel, F, tiles, weighted):
    """Each slot kernel against its plain version on a plan with a hub row
    spanning many tiles, pad slots before (pack_align 16) and after a
    tile's real slots, and empty windows; every row is written (the output
    memory is NaN-filled first), reruns are bit-identical, one launch."""
    e_tile, s_tile, pack_align = tiles
    rng = np.random.default_rng(F + e_tile + weighted)
    n = 1500
    src, dst = _hubby(rng, n, 6000, 3000, hub=9)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    plan = tplan.build_segment_plan(dst, src, n + 400, e_tile=e_tile, s_tile=s_tile,
                                    pack_align=pack_align, device=cuda)
    T, E = plan.num_tiles, plan.e_tile
    w = plan.mask.clone()
    if weighted:
        w *= torch.from_numpy(rng.standard_normal((T, E)).astype(np.float32)).to(cuda)
    shape = (F, T * E) if kernel == "pr" else (T * E, F)
    vals = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    fn, plain = _SLOT[kernel]
    torch.full((4 * plan.n_blocks * s_tile * max(F, 8),), float("nan"), device=cuda)
    before = fn.launches
    k = fn(plan, vals, w)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    p = plain(plan, vals, w)
    _assert_abs_sum(k, p, plain(plan, vals.abs(), w.abs()))
    assert torch.equal(fn(plan, vals, w), k)


@pytest.mark.parametrize("kernel,F", [("sr_packed", 64), ("sr_packed", 32),
                                      ("sr_packed", 16), ("sr_packed", 8), ("pr", 8),
                                      ("sr", 128), ("sr2", 128), ("sr2", 16),
                                      ("sr2_edge", 500), ("packed2", 64), ("packed2", 8),
                                      ("mh", 128), ("mh", 14)])
@pytest.mark.parametrize("tiles", [(512, 256, 1), (64, 32, 16)])
def test_slot_kernels_zero_weight_edges(cuda, kernel, F, tiles):
    """Real slots of weight exactly 0 inside a row's run: every other slot
    of the hub row and a third of the others. The kernels skip them as
    they skip pads, and each run must still be summed once: the packed
    kernels' segmented sum over the slots in flight must not carry a run
    past a skipped slot (rows [5, -1, 5, 5] once added b + c twice). The
    AEB kernels meet the zeros as per-call weights in edge order (sr2,
    packed2) or as static weights over edge-order values (sr2_edge); mh
    as weights zero on one head only or on both (`_two_heads`)."""
    e_tile, s_tile, pack_align = tiles
    rng = np.random.default_rng(F + e_tile)
    n, hub = 1500, 9
    src, dst = _hubby(rng, n, 6000, 3000, hub=hub)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    plan = tplan.build_segment_plan(dst, src, n + 400, e_tile=e_tile, s_tile=s_tile,
                                    pack_align=pack_align, device=cuda)
    T, E = plan.num_tiles, plan.e_tile
    w = plan.mask * torch.from_numpy(rng.standard_normal((T, E)).astype(np.float32)).to(cuda)
    slot = torch.arange(T * E, device=cuda).reshape(T, E)
    in_hub = (plan.dst_slots == hub) & (plan.mask > 0)
    third = torch.from_numpy(rng.random((T, E)) < 1 / 3).to(cuda)
    drop = (in_hub & (slot % 2 == 1)) | (~in_hub & third)
    w = torch.where(drop, torch.zeros_like(w), w)
    assert int((in_hub & (w == 0)).sum()) > 100 and int((in_hub & (w != 0)).sum()) > 100
    shape = (F, T * E) if kernel == "pr" else (T * E, F)
    vals = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    fn, plain = _SLOT[kernel]
    k = fn(plan, vals, w)
    torch.cuda.synchronize()
    _assert_abs_sum(k, plain(plan, vals, w), plain(plan, vals.abs(), w.abs()))
    assert torch.equal(fn(plan, vals, w), k)


@pytest.mark.parametrize("F", [64, 32, 16, 8, 7, 1])
@pytest.mark.parametrize("tiles", [(512, 256, 1), (64, 32, 16), (32, 1, 1)])
@pytest.mark.parametrize("chunked", [False, True])
def test_sr_packed_gathered_matches_plain(cuda, F, tiles, chunked):
    """plan_segment_sum_sr_packed reading x[src[e]] itself (src the plan's
    edge-order src) and over slot-order values, with every third slot
    weight exactly 0 (skipped), against the plain version: one launch a
    plan, chunked (the hub window split) or not, every row written,
    reruns bit-identical, the two forms within the rule of each other."""
    e_tile, s_tile, pack_align = tiles
    rng = np.random.default_rng(F + e_tile + chunked)
    n = 1500
    src, dst = _hubby(rng, n, 6000, 3000, hub=9)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    plan = tplan.build_segment_plan(dst, src, n + 400, e_tile=e_tile, s_tile=s_tile,
                                    pack_align=pack_align, device=cuda,
                                    max_chunk_slots=e_tile * 6 if chunked else 4 << 20)
    assert bool(plan.chunks) == chunked
    T, E = plan.num_tiles, plan.e_tile
    w = plan.mask * torch.from_numpy(rng.standard_normal((T, E)).astype(np.float32)).to(cuda)
    w.reshape(-1)[::3] = 0.0
    x = torch.from_numpy(rng.standard_normal((n, F)).astype(np.float32)).to(cuda)
    s = torch.from_numpy(src).to(cuda)
    fn, plain = _SLOT["sr_packed"]
    torch.full((4 * plan.n_blocks * s_tile * max(F, 8),), float("nan"), device=cuda)
    before = fn.launches
    k = fn(plan, x, w, src=s)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    _assert_abs_sum(k, plain(plan, x, w, src=s), plain(plan, x.abs(), w.abs(), src=s))
    assert torch.equal(fn(plan, x, w, src=s), k)
    vals = x.index_select(0, plan.src_slots.reshape(-1).long())
    kv = fn(plan, vals, w)
    _assert_abs_sum(kv, plain(plan, vals, w), plain(plan, vals.abs(), w.abs()))
    _assert_abs_sum(kv, k, plain(plan, vals.abs(), w.abs()))


def test_slot_kernels_refuse_what_they_do_not_take(cuda):
    """Width, dtype, shape, the slot-order row count and the gathered
    form's src are checked before a launch; a plan whose out_block is not
    non-decreasing as a whole (uniformized chunks) is summed whole by sr
    (the edge-row kernel) and by pr (over the same row schedule)."""
    rng = np.random.default_rng(3)
    dst = np.sort(rng.integers(0, 300, 2000)).astype(np.int32)
    plan = tplan.build_segment_plan(dst, dst, 300, e_tile=64, s_tile=32, device=cuda)
    v = torch.ones(plan.num_tiles * 64, 65, device=cuda)
    with pytest.raises(ValueError, match="F <= 64"):
        tslot.plan_segment_sum_sr_packed(plan, v, plan.mask)
    with pytest.raises(ValueError, match="float32"):
        tslot.plan_segment_sum_sr(plan, v.double(), plan.mask)
    with pytest.raises(ValueError, match="w_slots"):
        tslot.plan_segment_sum_sr(plan, v, plan.mask[:-1])
    with pytest.raises(ValueError, match="rows"):
        tslot.plan_segment_sum_sr(plan, v[:-1], plan.mask)  # slot order needs T*E rows
    src = torch.from_numpy(dst).to(cuda)
    with pytest.raises(ValueError, match="src"):
        tslot.plan_segment_sum_sr(plan, v, plan.mask, src=src.long())
    with pytest.raises(ValueError, match="src"):
        tslot.plan_segment_sum_sr(plan, v, plan.mask, src=src[None])
    chunked = tplan.build_segment_plan(dst, dst, 300, e_tile=64, s_tile=32,
                                       max_chunk_slots=64 * 5, device=cuda)
    vc = torch.randn(chunked.num_tiles * 64, 65, device=cuda)
    k = tslot.plan_segment_sum_sr(chunked, vc, chunked.mask)
    _assert_abs_sum(k, tref.plan_segment_sum_sr_plain(chunked, vc, chunked.mask),
                    tref.plan_segment_sum_sr_plain(chunked, vc.abs(), chunked.mask))
    # pr sums a plan whose uniformized chunks put out_block out of order as
    # a whole (it once refused one), the plan whole
    hs, hd = _hubby(np.random.default_rng(1), 1500, 6000, 3000, hub=9)
    o = np.argsort(hd, kind="stable")
    disorder = tplan.build_segment_plan(hd[o], hs[o], 1900, e_tile=64, s_tile=32,
                                        pack_align=16, max_chunk_slots=64 * 6, device=cuda)
    ob = disorder.out_block
    assert bool((ob[1:] < ob[:-1]).any()), "the plan is in window order as a whole"
    vt = torch.randn(8, disorder.num_tiles * 64, device=cuda)
    _assert_abs_sum(tslot.plan_segment_sum_pr(disorder, vt, disorder.mask),
                    tref.plan_segment_sum_pr_plain(disorder, vt, disorder.mask),
                    tref.plan_segment_sum_pr_plain(disorder, vt.abs(), disorder.mask))
    with pytest.raises(ValueError, match="columns"):
        tslot.plan_segment_sum_pr(plan, v[:-1, :8].t().contiguous(), plan.mask)
    with pytest.raises(ValueError, match="rows"):
        tslot.plan_segment_sum_pr(plan, torch.ones(1, 5000, device=cuda), plan.mask, src=src)


@pytest.mark.parametrize("model", ["gcn", "graphsage"])
@pytest.mark.parametrize("chunked", [False, True])
def test_slot_models_on_card_match_cpu(cuda, model, chunked):
    """GCN (slot_static) and GraphSAGE (slot, mean) over slot graphs, the
    forward and the x gradient on the card against the CPU's plain path;
    with a small max_chunk_slots the hub window splits across chunks."""
    from geot_tpu_torch.models import MODELS, prepare_graph

    cls, loops = MODELS[model]
    rng = np.random.default_rng(11)
    n = 3000
    src, dst = _hubby(rng, n, 20000, 4000, hub=5)
    kw = dict(add_self_loops=loops, normalize="gcn" if loops else None, e_tile=512,
              s_tile=256, mode_hint="sr", prefer="sr", layouts=("bat", "slot"),
              max_chunk_slots=512 * 6 if chunked else 4 << 20)
    gc = prepare_graph(src, dst, n, device=cuda, **kw)
    gh = prepare_graph(src, dst, n, device="cpu", **kw)
    assert api.dispatch_path(gc, reduce="mean" if not loops else "sum") == (
        "slot_static" if loops else "slot")
    assert bool(gc.plan.chunks) == chunked
    x = torch.from_numpy(rng.standard_normal((n, 100)).astype(np.float32))
    outs = []
    for g, dev in ((gc, cuda), (gh, "cpu")):
        m = cls(100, 64, 3, 7, generator=torch.Generator().manual_seed(0), device=dev)
        xx = x.to(dev).requires_grad_()
        out = m(xx, g)
        out.square().sum().backward()
        outs.append((out.detach().cpu(), xx.grad.cpu()))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=1e-4,
                               atol=1e-4 * float(outs[1][1].abs().max()))


@pytest.mark.parametrize("kernel,F", [("sr2", 500), ("sr2", 128), ("sr2", 64), ("sr2", 7),
                                      ("sr2_edge", 128), ("sr2_edge", 100), ("sr2_edge", 7),
                                      ("packed2", 64), ("packed2", 32), ("packed2", 16),
                                      ("packed2", 8), ("packed2", 7), ("packed2", 1),
                                      ("sr2_src", 128), ("sr2_src", 64), ("sr2_src", 7),
                                      ("packed2_src", 64), ("packed2_src", 16),
                                      ("packed2_src", 8), ("packed2_src", 7),
                                      ("packed2_src", 1)])
@pytest.mark.parametrize("tiles", [(512, 256, 1), (64, 32, 16), (96, 128, 1), (32, 1, 1)])
@pytest.mark.parametrize("weights", ["static", "dynamic", "both"])
def test_aeb_kernels_match_plain(cuda, kernel, F, tiles, weights):
    """sr2 (slot- or edge-order values) and packed2 (edge order) against
    their plain versions on plans with a hub row over many tiles, pad slots
    before and after a tile's real ones, and empty windows; static and/or
    per-call weights; values read from a slice of the edge order (e_base);
    and the gathered form (`_src`: edge e reads x[src[e]] in the kernel,
    x short of the largest src so its last rows read as zero, per-call
    weights short of the edges so the last weigh 0); every row written (the
    memory NaN-filled first), reruns bit-identical, one launch."""
    e_tile, s_tile, pack_align = tiles
    rng = np.random.default_rng(F + e_tile + len(weights))
    n = 1500
    src, dst = _hubby(rng, n, 6000, 3000, hub=9)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    plan = tplan.build_segment_plan(dst, src, n + 400, e_tile=e_tile, s_tile=s_tile,
                                    pack_align=pack_align, device=cuda)
    T, E, nnz = plan.num_tiles, plan.e_tile, len(dst)
    gathered = kernel.endswith("_src")
    ws = we = None
    if weights in ("static", "both"):
        ws = plan.mask * torch.from_numpy(rng.standard_normal((T, E)).astype(np.float32)).to(cuda)
    if weights in ("dynamic", "both"):
        we = torch.from_numpy(rng.standard_normal(nnz).astype(np.float32)).to(cuda)
        if gathered:
            we = we[: nnz - 300]
    edge = kernel != "sr2"
    rows = n - 200 if gathered else nnz if edge else T * E
    vals = torch.from_numpy(rng.standard_normal((rows, F)).astype(np.float32)).to(cuda)
    kw = dict(w_slots=ws, w_edge=we)
    if gathered:
        kw["src"] = torch.from_numpy(src).to(cuda)
    elif edge:
        kw["e_base"] = 40
        vals = vals[40:]
    if kernel.startswith("sr2"):
        kw["vals_layout"] = "edge" if edge else "slot"
        fn, plain = tslot.plan_segment_sum_sr2, tref.plan_segment_sum_sr2_plain
    else:
        fn, plain = tslot.plan_segment_sum_packed2, tref.plan_segment_sum_packed2_plain
    abs_kw = dict(kw, w_slots=None if ws is None else ws.abs(),
                  w_edge=None if we is None else we.abs())
    torch.full((4 * plan.n_blocks * s_tile * max(F, 8),), float("nan"), device=cuda)
    before = fn.launches
    k = fn(plan, vals, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    _assert_abs_sum(k, plain(plan, vals, **kw), plain(plan, vals.abs(), **abs_kw))
    assert torch.equal(fn(plan, vals, **kw), k)


@pytest.mark.parametrize("F", [1, 7, 8, 16, 33, 64, 128])
@pytest.mark.parametrize("form", ["values", "gathered"])
def test_edge_row_kernel_deep_fix_tree(cuda, F, form):
    """The edge-row kernel over schedules of tiny slices (4 edges) and
    fan-in 2, so the hub row (3,000 edges) is added through 3 or more
    fix-up levels, on a slot plan (sr2, every fifth per-call weight exactly
    0) and a packed BAT plan (bat_segment_sum_packed, every fifth weight 0
    adds 0 * v): both forms against the plain versions, reruns
    bit-identical."""
    rng = np.random.default_rng(F + len(form))
    n = 1500
    src, dst = _hubby(rng, n, 6000, 3000, hub=9)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    nnz = len(dst)
    knobs = dict(slice_slots=4, fix_fanin=2, task_cost=16)
    plan = tplan.with_row_schedule(
        tplan.build_segment_plan(dst, src, n + 400, e_tile=64, s_tile=32, pack_align=16,
                                 device=cuda), **knobs)
    assert len(plan.row_sched.fix_levels) - 1 >= 3
    we = torch.from_numpy(rng.standard_normal(nnz).astype(np.float32)).to(cuda)
    we[::5] = 0.0
    src_t = torch.from_numpy(src).to(cuda)
    if form == "gathered":
        vals = torch.from_numpy(rng.standard_normal((n - 100, F)).astype(np.float32)).to(cuda)
        kw = dict(src=src_t)
    else:
        vals = torch.from_numpy(rng.standard_normal((nnz, F)).astype(np.float32)).to(cuda)
        kw = {}
    k = tslot.plan_segment_sum_sr2(plan, vals, vals_layout="edge", w_edge=we, **kw)
    torch.cuda.synchronize()
    p = tref.plan_segment_sum_sr2_plain(plan, vals, vals_layout="edge", w_edge=we, **kw)
    a = tref.plan_segment_sum_sr2_plain(plan, vals.abs(), vals_layout="edge", w_edge=we.abs(),
                                        **kw)
    _assert_abs_sum(k, p, a)
    assert torch.equal(tslot.plan_segment_sum_sr2(plan, vals, vals_layout="edge", w_edge=we,
                                                  **kw), k)
    Fp = tplan.packed_width(F)
    if not Fp:
        return
    bp = tplan.with_row_schedule(
        tplan.build_bat_plan(dst, n + 400, e_tile=64, s_tile=32, km_pack=128 // Fp,
                             device=cuda), **knobs)
    assert len(bp.row_sched.fix_levels) - 1 >= 3
    vp = torch.nn.functional.pad(vals, (0, Fp - F)).contiguous()
    k = bat_segment_sum_packed(bp, vp, we, **kw)
    torch.cuda.synchronize()
    p = tref.bat_segment_sum_packed_plain(bp, vp, we, **kw)
    _assert_abs_sum(k, p, tref.bat_segment_sum_packed_plain(bp, vp.abs(), we.abs(), **kw))
    assert torch.equal(bat_segment_sum_packed(bp, vp, we, **kw), k)


def _both_directions(cuda, seed, tiles, chunked, n=1500):
    """A slot graph with a hub row spanning many tiles, pad slots before
    (pack_align 16) and after a tile's real slots, empty windows and,
    chunked, uniformized chunks that split the hub window; and x [n - 100,
    .] so that the node rows past its end read as zero. Yields (plan, its
    edge-order src) for `plan` and `plan_t`."""
    e_tile, s_tile, pack_align = tiles
    rng = np.random.default_rng(seed)
    src, dst = _hubby(rng, n, 6000, 3000, hub=9)
    g = build_graph(src, dst, n + 400, e_tile=e_tile, s_tile=s_tile,
                    feature_hint=64 if pack_align == 16 else 128, layouts=("slot",),
                    device=cuda, max_chunk_slots=e_tile * 6 if chunked else 4 << 20)
    assert bool(g.plan.chunks) == chunked and g.plan.pack_align == pack_align
    return rng, ((g.plan, g.src), (g.plan_t, g.dst_t))


def _slot_rows(x, plan):
    """x[src_slots] [T*E, F] with zeros where a slot names a row past x's
    end: the values form of a gathered sum."""
    ss = plan.src_slots.reshape(-1).long()
    inside = ss < x.shape[0]
    return torch.where(inside[:, None], x[ss.clamp(max=x.shape[0] - 1)], 0.0).contiguous()


def _held_both_forms(fn, plain, plan, x, src_e, w_vals, w_edge, *extra):
    """fn in both forms (slot-order values with weights w_vals; x[src[e]]
    read in the kernel with weights w_edge) against its plain version in
    the same form, one launch each, every row written, three reruns
    bit-identical, and the two forms within the rule of each other."""
    vals = _slot_rows(x, plan)
    outs = []
    for v, w, kw in ((vals, w_vals, {}), (x, w_edge, {"src": src_e})):
        torch.full((4 * plan.n_blocks * plan.s_tile * max(x.shape[1], 8),), float("nan"),
                   device=x.device)
        before = fn.launches
        k = fn(plan, v, w, *extra, **kw)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        _assert_abs_sum(k, plain(plan, v, w, *extra, **kw),
                        plain(plan, v.abs(), w.abs(), *extra, **kw))
        for _ in range(3):
            assert torch.equal(fn(plan, v, w, *extra, **kw), k)
        outs.append(k)
    _assert_abs_sum(outs[1], outs[0], plain(plan, vals.abs(), w_vals.abs(), *extra))


@pytest.mark.parametrize("F", [500, 128, 100, 7])
@pytest.mark.parametrize("tiles", [(512, 256, 1), (64, 32, 16), (96, 128, 1), (32, 1, 1)])
@pytest.mark.parametrize("chunked", [False, True])
def test_sr_both_forms_match_plain(cuda, F, tiles, chunked):
    """plan_segment_sum_sr (the edge-row kernel) over slot-order values and
    reading x[src[e]] itself, on both directions' plans, with a third of
    the slot weights exactly 0 (skipped) and node rows past x's end: one
    launch a plan, chunked (the hub window split) or not."""
    rng, plans = _both_directions(cuda, F + tiles[0] + chunked, tiles, chunked)
    fn, plain = _SLOT["sr"]
    for plan, src_e in plans:
        w = plan.mask * torch.from_numpy(rng.standard_normal(tuple(plan.mask.shape))
                                         .astype(np.float32)).to(cuda)
        w.reshape(-1)[::3] = 0.0
        x = torch.from_numpy(rng.standard_normal((1400, F)).astype(np.float32)).to(cuda)
        _held_both_forms(fn, plain, plan, x, src_e, w, w)


@pytest.mark.parametrize("H,D", [(4, 64), (4, 7), (3, 96), (8, 32), (2, 100), (4, 16),
                                 (1, 1)])
@pytest.mark.parametrize("tiles", [(512, 256, 1), (64, 32, 16), (32, 1, 1)])
@pytest.mark.parametrize("chunked", [False, True])
def test_mh_kernel_matches_plain(cuda, H, D, tiles, chunked):
    """plan_segment_sum_mh (the edge-row kernel with per-head weights) in
    both forms (slot-order values and weights; x[src[e]] read in the
    kernel with the weights in the plan's edge order) on both directions'
    plans: heads that straddle a lane's 4 columns ((4, 7)) or a 128-column
    slab ((3, 96): head 1 spans columns 96-191), a third of the (edge,
    head) weights exactly 0 on chosen heads only and every seventh edge 0
    on every head (skipped), pads zero on every head, node rows past x's
    end; one launch a plan, chunked or not, reruns bit-identical."""
    rng, plans = _both_directions(cuda, H * 100 + D + tiles[0] + chunked, tiles, chunked)
    fn, plain = tslot.plan_segment_sum_mh, tref.plan_segment_sum_mh_plain
    for plan, src_e in plans:
        nnz = plan.num_edges
        we = torch.from_numpy(rng.standard_normal((nnz, H)).astype(np.float32)).to(cuda)
        we[torch.from_numpy(rng.random((nnz, H)) < 1 / 3).to(cuda)] = 0.0
        we[torch.arange(nnz, device=cuda) % 7 == 3] = 0.0
        ws = (we[plan.edge_pos.reshape(-1).long()] * plan.mask.reshape(-1, 1)).contiguous()
        x = torch.from_numpy(rng.standard_normal((1400, H * D)).astype(np.float32)).to(cuda)
        _held_both_forms(fn, plain, plan, x, src_e, ws, we, D)


def test_aeb_and_mh_kernels_refuse_what_they_do_not_take(cuda):
    """Width, layout, dtype, shape, e0, head_dim and the gathered form's src
    are checked before a launch; a plan whose out_block is not
    non-decreasing as a whole (uniformized chunks) is summed whole by sr2
    and mh (the edge-row kernel)."""
    rng = np.random.default_rng(4)
    dst = np.sort(rng.integers(0, 300, 2000)).astype(np.int32)
    plan = tplan.build_segment_plan(dst, dst, 300, e_tile=64, s_tile=32, device=cuda)
    S = plan.num_tiles * 64
    ve = torch.ones(2000, 65, device=cuda)
    with pytest.raises(ValueError, match="F <= 64"):
        tslot.plan_segment_sum_packed2(plan, ve)
    with pytest.raises(ValueError, match="vals_layout"):
        tslot.plan_segment_sum_sr2(plan, ve, vals_layout="slots")
    with pytest.raises(ValueError, match="rows"):
        tslot.plan_segment_sum_sr2(plan, ve)  # slot order needs T*E rows
    with pytest.raises(ValueError, match="w_edge"):
        tslot.plan_segment_sum_sr2(plan, ve, vals_layout="edge",
                                   w_edge=torch.ones(2000, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="e0"):
        tslot.plan_segment_sum_sr2(dataclasses.replace(plan, e0=None), ve, vals_layout="edge")
    with pytest.raises(ValueError, match="w_heads"):
        tslot.plan_segment_sum_mh(plan, torch.ones(S, 8, device=cuda),
                                  torch.ones(S - 1, 2, device=cuda), 4)
    src = torch.from_numpy(dst).to(cuda)
    x8 = torch.ones(300, 8, device=cuda)
    with pytest.raises(ValueError, match="w_heads"):
        tslot.plan_segment_sum_mh(plan, x8, torch.ones(2000, 2, device=cuda).double(), 4,
                                  src=src)
    with pytest.raises(ValueError, match="w_heads"):
        tslot.plan_segment_sum_mh(plan, x8, torch.ones(2000, device=cuda), 4, src=src)
    with pytest.raises(ValueError, match="head_dim"):
        tslot.plan_segment_sum_mh(plan, x8, torch.ones(2000, 2, device=cuda), 0, src=src)
    with pytest.raises(ValueError, match="src"):
        tslot.plan_segment_sum_mh(plan, x8, torch.ones(2000, 2, device=cuda), 4,
                                  src=src.long())
    with pytest.raises(ValueError, match="vals_layout"):
        tslot.plan_segment_sum_sr2(plan, ve, src=src)  # gathered values are edge order
    with pytest.raises(ValueError, match="src"):
        tslot.plan_segment_sum_sr2(plan, ve, vals_layout="edge", src=src.long())
    with pytest.raises(ValueError, match="e_base"):
        tslot.plan_segment_sum_packed2(plan, ve[:, :8].contiguous(), src=src, e_base=64)
    # a plan cut into uniformized chunks: the edge-row kernel sums it whole,
    # in one launch
    chunked = tplan.build_segment_plan(dst, dst, 300, e_tile=64, s_tile=32,
                                       max_chunk_slots=64 * 5, device=cuda)
    v8 = ve[:, :8].contiguous()
    k = tslot.plan_segment_sum_sr2(chunked, v8, vals_layout="edge")
    _assert_abs_sum(k, tref.plan_segment_sum_sr2_plain(chunked, v8, vals_layout="edge"),
                    tref.plan_segment_sum_sr2_plain(chunked, v8, vals_layout="edge"))
    wh = torch.rand(2000, 2, device=cuda)
    k = tslot.plan_segment_sum_mh(chunked, x8, wh, 4, src=src)
    _assert_abs_sum(k, tref.plan_segment_sum_mh_plain(chunked, x8, wh, 4, src=src),
                    tref.plan_segment_sum_mh_plain(chunked, x8, wh, 4, src=src))


@pytest.mark.parametrize("model", ["gat", "gcn_dyn64", "gcn_dyn128"])
@pytest.mark.parametrize("chunked", [False, True])
def test_gat_and_slot_dyn_models_on_card_match_cpu(cuda, model, chunked):
    """GAT (4 heads averaged, the fused route) and GCN with its per-forward
    norm over slot plans (slot_dyn; feature_hint 64: packed2, 128: sr2),
    forward and the x gradient on the card against the CPU's plain path;
    with a small max_chunk_slots the hub window splits across chunks.
    index_scatter over the slot plan too."""
    from geot_tpu_torch.models import GAT, prepare_graph

    rng = np.random.default_rng(13)
    n = 3000
    src, dst = _hubby(rng, n, 20000, 4000, hub=5)
    kw = dict(add_self_loops=True, e_tile=512, s_tile=256, mode_hint="sr", prefer="sr",
              prefer_dyn="sr", layouts=("slot",),
              feature_hint=64 if model == "gcn_dyn64" else 128,
              max_chunk_slots=512 * 6 if chunked else 4 << 20)
    gc = prepare_graph(src, dst, n, device=cuda, **kw)
    gh = prepare_graph(src, dst, n, device="cpu", **kw)
    assert bool(gc.plan.chunks) == chunked
    if model != "gat":
        assert api.dispatch_path(gc, dynamic_w=True) == "slot_dyn"
    x = torch.from_numpy(rng.standard_normal((n, 100)).astype(np.float32))
    outs = []
    for g, dev in ((gc, cuda), (gh, "cpu")):
        gen = torch.Generator().manual_seed(0)
        if model == "gat":
            m = GAT(100, 64, 3, 7, conv_kwargs={"heads": 4, "concat": False}, generator=gen,
                    device=dev)
        else:
            m = GCN(100, 64, 3, 7, generator=gen, device=dev)
        xx = x.to(dev).requires_grad_()
        out = m(xx, g)
        out.square().sum().backward()
        v = x.to(dev)[g.src.long()][:, :24]
        sc = api.index_scatter(v, g.dst, n, plan=g.plan)
        outs.append((out.detach().cpu(), xx.grad.cpu(), sc.cpu()))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=1e-4,
                               atol=1e-4 * float(outs[1][1].abs().max()))
    torch.testing.assert_close(outs[0][2], outs[1][2], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("route", [{}, {"fused_max_edges": 0}])
def test_gat_attention_gradients_rerun_bit_identical(cuda, route):
    """The gradients of alpha_src and alpha_dst sum in a fixed order (the
    attention's gradient is the per-edge, per-head dot in edge order, and
    the edge softmax's backward sums over the dst runs and the src-sorted
    runs with no atomics), so reruns give the same bits; so does the xh
    gradient on both routes (the mh kernel over plan_t; the fused route
    added slot terms with index_add_ once, ROADMAP C.12). Both routes are
    one computation on the card, through the edge softmax kernel (one
    forward and one backward launch a call)."""
    from geot_tpu_torch.ops.softmax_kernels import edge_softmax, edge_softmax_grad

    from geot_tpu_torch.models import prepare_graph

    rng = np.random.default_rng(21)
    n, H, D = 3000, 4, 16
    src, dst = _hubby(rng, n, 20000, 4000, hub=5)
    g = prepare_graph(src, dst, n, device=cuda, add_self_loops=True, e_tile=512, s_tile=256,
                      mode_hint="sr", layouts=("slot",))
    gen = torch.Generator(device=cuda).manual_seed(0)
    xh = torch.randn(n, H, D, generator=gen, device=cuda)
    a_s = torch.randn(n, H, generator=gen, device=cuda)
    a_d = torch.randn(n, H, generator=gen, device=cuda)
    co = torch.randn(n, H, D, generator=gen, device=cuda)
    grads = []
    for _ in range(3):
        args = [t.clone().requires_grad_() for t in (xh, a_s, a_d)]
        before = edge_softmax.launches, edge_softmax_grad.launches
        out = api.gat_attention_spmm(g, *args, **route)
        torch.vdot(out.reshape(-1), co.reshape(-1)).backward()
        assert (edge_softmax.launches, edge_softmax_grad.launches) == (before[0] + 1,
                                                                       before[1] + 1)
        grads.append([t.grad for t in args])
    for later in grads[1:]:
        assert torch.equal(later[1], grads[0][1]) and torch.equal(later[2], grads[0][2])
        assert torch.equal(later[0], grads[0][0])


def _packed_inputs(rng, cuda, F, n=700, nnz=5000, hub_edges=1500, e_tile=512, s_tile=256,
                   weights="none", rows=None):
    """A packed BAT plan (km_pack 128 // F, dst sorted, a hub row of
    `hub_edges` in-edges, windows of s_tile over n + 300 rows so the last
    are empty) with edge-order values [rows (default nnz), F] and weights:
    none, random, or random with every third edge exactly 0 (inside the
    hub row's run too)."""
    _, dst = _hubby(rng, n, nnz, hub_edges)
    dst = np.sort(dst)
    pack = 128 // F
    bp = tplan.build_bat_plan(dst, n + 300, e_tile=e_tile, s_tile=s_tile, km_pack=pack,
                              device=cuda)
    assert bp.km_pack == pack and bp.dst_km is not None
    m = len(dst)
    vals = torch.from_numpy(rng.standard_normal((rows or m, F)).astype(np.float32)).to(cuda)
    w = None
    if weights != "none":
        w = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(cuda)
        if weights == "zeros":
            w[torch.arange(m, device=cuda) % 3 == 1] = 0.0
    return bp, dst, vals, w


@pytest.mark.parametrize("F", [8, 16, 32, 64])
@pytest.mark.parametrize("weights", ["none", "random", "zeros"])
@pytest.mark.parametrize("e_tile,s_tile", [(512, 256), (64, 32), (32, 4), (96, 8)])
@pytest.mark.parametrize("form", ["values", "gathered"])
def test_packed_kernel_matches_plain(cuda, F, weights, e_tile, s_tile, form):
    """bat_segment_sum_packed against its plain version at packs 16 to 2,
    with -1 pads (the last value block and the sentinel), out-of-window
    edges (blocks that span windows), empty windows, a ragged tail (rows
    short of whole blocks) and zero-weight edges inside the hub run; in the
    gathered form edge e reads x[src[e]] in the kernel (src past x's rows
    reads zeros); reruns bit-identical."""
    rng = np.random.default_rng(F + e_tile + len(weights))
    bp, _, vals, w = _packed_inputs(rng, cuda, F, e_tile=e_tile, s_tile=s_tile,
                                    weights=weights)
    assert vals.shape[0] % e_tile, "meant to leave a ragged tail"
    kw = {}
    if form == "gathered":
        kw["src"] = torch.from_numpy(rng.integers(0, 700, vals.shape[0]).astype(np.int32)).to(
            cuda)
        vals = vals[:600].contiguous()
    torch.full((bp.n_blocks * s_tile + 4 * bp.num_tiles, F), float("nan"), device=cuda)
    before = bat_segment_sum_packed.launches
    k = bat_segment_sum_packed(bp, vals, w, **kw)
    torch.cuda.synchronize()
    assert bat_segment_sum_packed.launches == before + 1
    p = tref.bat_segment_sum_packed_plain(bp, vals, w, **kw)
    a = tref.bat_segment_sum_packed_plain(bp, vals.abs(), None if w is None else w.abs(), **kw)
    assert k.shape == p.shape == (bp.n_blocks * s_tile, F)
    _assert_abs_sum(k, p, a)
    for _ in range(2):
        assert torch.equal(bat_segment_sum_packed(bp, vals, w, **kw), k)


def test_packed_kernel_reads_rows_past_the_end_as_zero(cuda):
    """vals and weights shorter than the plan's edges: the missing rows and
    weights read as zero, as in the plain version."""
    rng = np.random.default_rng(4)
    bp, dst, vals, w = _packed_inputs(rng, cuda, 16, rows=3000, weights="random")
    k = bat_segment_sum_packed(bp, vals, w[:2500])
    torch.cuda.synchronize()
    p = tref.bat_segment_sum_packed_plain(bp, vals, w[:2500])
    _assert_abs_sum(k, p, tref.bat_segment_sum_packed_plain(bp, vals.abs(), w[:2500].abs()))


@pytest.mark.parametrize("F", [8, 64])
def test_packed_spmm_chunked_split_hub_on_card(cuda, F):
    """The packed route of segment_spmm over a plan forced into chunks that
    split the hub window (`with_chunks`) against the unchunked plain sum:
    one launch per plan, the chunks summed whole."""
    rng = np.random.default_rng(70 + F)
    n = 600
    src, dst = _hubby(rng, n, 4000, 3000, hub=3)
    w = rng.standard_normal(len(dst)).astype(np.float32)
    g = build_graph(src, dst, n, edge_weight=w, bat_e_tile=64, bat_s_tile=32,
                    feature_hint=F, layouts=("bat",), device=cuda)
    ch = tplan.compute_chunks(g.bat.out_block.cpu().numpy(), 8)
    assert len(ch) > 2 and any(b[2] < a[3] for a, b in zip(ch[:-1], ch[1:]))
    gc = dataclasses.replace(g, bat=tplan.with_chunks(g.bat, ch))
    x = torch.from_numpy(rng.standard_normal((n, F)).astype(np.float32)).to(cuda)
    before = bat_segment_sum_packed.launches
    with torch.inference_mode():
        out = api.segment_spmm(gc, x)
        whole = api.segment_spmm(g, x)
    assert bat_segment_sum_packed.launches == before + 2
    exp = tref.gather_weight_scatter_ref(g.src, g.dst, g.edge_weight, x, n)
    a = tref.gather_weight_scatter_ref(g.src, g.dst, g.edge_weight.abs(), x.abs(), n)
    _assert_abs_sum(out, exp, a)
    _assert_abs_sum(whole, exp, a)


def test_packed_kernel_refuses_what_it_does_not_take(cuda):
    rng = np.random.default_rng(9)
    bp, _, vals, _ = _packed_inputs(rng, cuda, 32)
    before = bat_segment_sum_packed.launches
    for bad in (vals[:, :16].contiguous(), vals.double(), vals[:, :7].contiguous()):
        with pytest.raises(ValueError):
            bat_segment_sum_packed(bp, bad)
    with pytest.raises(ValueError):
        bat_segment_sum_packed(dataclasses.replace(bp, dst_km=None), vals)
    with pytest.raises(ValueError, match="src"):
        bat_segment_sum_packed(bp, vals, src=torch.zeros(10, dtype=torch.int64, device=cuda))
    assert bat_segment_sum_packed.launches == before


@pytest.mark.parametrize("model", ["gin", "appnp", "sgc"])
def test_narrow_models_on_card_match_cpu(cuda, model):
    """GIN (hidden 64: packed layers 2-3 at pack 2, over bat and bat_t),
    APPNP (7 classes: 10 packed propagations with per-call weights at pack
    16) and SGC on the card against the same model on the CPU path, forward
    and input gradient."""
    from geot_tpu_torch.models import MODELS, prepare_graph

    rng = np.random.default_rng(33)
    n, f = 2000, 48
    src, dst = _hubby(rng, n, 16000, 2500, hub=11)
    cls, loops = MODELS[model]
    hidden, out_dim = (64, 40) if model == "gin" else (32, 7)
    # the width each model aggregates at: GIN's hidden, APPNP's classes,
    # SGC's input features (48, packed at 64)
    fh = {"gin": hidden, "appnp": out_dim, "sgc": f}[model]
    kw = dict(add_self_loops=loops, layouts=("bat",), bat_e_tile=512, bat_s_tile=256,
              feature_hint=fh)
    gc = prepare_graph(src, dst, n, device=cuda, **kw)
    gh = prepare_graph(src, dst, n, device="cpu", **kw)
    assert gc.bat.km_pack == (16 if model == "appnp" else 2)
    x = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32))
    co = torch.from_numpy(rng.standard_normal((n, out_dim)).astype(np.float32))
    outs = []
    for dev, g in ((cuda, gc), ("cpu", gh)):
        m = cls(f, hidden, 3, out_dim, generator=torch.Generator().manual_seed(0),
                device=dev).eval()
        xx = x.to(dev).requires_grad_()
        before = bat_segment_sum_packed.launches
        out = m(xx, g)
        torch.vdot(out.reshape(-1), co.to(dev).reshape(-1)).backward()
        if dev == cuda:
            assert bat_segment_sum_packed.launches > before
        outs.append((out.detach().cpu(), xx.grad.cpu()))
    (oc, dc), (oh, dh) = outs
    torch.testing.assert_close(oc, oh, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dc, dh, rtol=1e-4, atol=1e-4 * float(dh.abs().max()))


# --- the per-edge dot (sddmm_bat, edge_dots) and the pr kernel over the
# row schedule: both forms, reruns bit-identical, rows past the end zero


@pytest.mark.parametrize("F", [128, 256, 100, 47, 1])
@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("form", ["values", "gathered"])
def test_sddmm_bat_both_forms_match_plain(cuda, F, chunked, form):
    """sddmm_bat over a BAT plan (chunked: uniformized, pad tiles past
    n_blocks) in the values form (b in edge order, ragged: rows past its
    end read zero) and the gathered one (b[src[e]] read in the kernel, a
    and b node rows, some of them past a's and b's ends), against the
    plain version; every slot written (NaN-filled memory first), pads 0,
    three reruns bit-identical, one launch each."""
    rng = np.random.default_rng(F + 2 * chunked + (form == "gathered"))
    n = 700
    src, dst = _hubby(rng, n, 5000, 1500)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    if chunked:
        bp = _chunked_plan_past_n_blocks(dst, n, 64, 32, cuda)
    else:
        bp = tplan.build_bat_plan(dst, n, e_tile=64, s_tile=32, device=cuda)
    nnz = len(dst)
    a = torch.from_numpy(rng.standard_normal((n - 5, F)).astype(np.float32)).to(cuda)
    kw = {}
    if form == "gathered":
        b = torch.from_numpy(rng.standard_normal((n - 9, F)).astype(np.float32)).to(cuda)
        kw["src"] = torch.from_numpy(src).to(cuda)
    else:
        b = torch.from_numpy(rng.standard_normal((nnz - 7, F)).astype(np.float32)).to(cuda)
    torch.full(((bp.n_vblocks + 1) * bp.e_tile,), float("nan"), device=cuda)
    before = sddmm_bat.launches
    k = sddmm_bat(bp, a, b, **kw)
    torch.cuda.synchronize()
    assert sddmm_bat.launches == before + 1
    assert k.shape == ((bp.n_vblocks + 1) * bp.e_tile,)
    _assert_abs_sum(k, sddmm_bat_plain(bp, a, b, **kw),
                    sddmm_bat_plain(bp, a.abs(), b.abs(), **kw))
    assert bool((k[nnz:] == 0).all())
    for _ in range(3):
        assert torch.equal(sddmm_bat(bp, a, b, **kw), k)


@pytest.mark.parametrize("H,D", [(4, 64), (4, 7), (3, 96), (1, 47), (8, 32), (2, 1)])
@pytest.mark.parametrize("form", ["values", "gathered"])
def test_edge_dots_per_head_match_plain(cuda, H, D, form):
    """edge_dots per head, against the plain version: GAT's (4, 64) and
    (4, 7) (heads straddling a lane's 4 columns), (3, 96) (a head across a
    128-column sub-slab), one head of 47 (rows not 16-byte aligned);
    -1 dst ids give 0 on every head, rows past a's and b's ends read
    zero, and in the gathered form edges past src's end read zero; every
    element written, reruns bit-identical, one launch counted."""
    rng = np.random.default_rng(H * 100 + D + (form == "gathered"))
    n, F = 600, H * D
    src, dst = _hubby(rng, n, 4000, 1200)
    dst = np.sort(dst)
    dst[::97] = -1
    a = torch.from_numpy(rng.standard_normal((n - 3, F)).astype(np.float32)).to(cuda)
    d = torch.from_numpy(dst).to(cuda)
    if form == "gathered":
        b = torch.from_numpy(rng.standard_normal((n - 11, F)).astype(np.float32)).to(cuda)
        s = torch.from_numpy(src[:-5]).to(cuda)
    else:
        b = torch.from_numpy(rng.standard_normal((len(dst) - 13, F)).astype(np.float32)).to(cuda)
        s = None
    torch.full((4 * len(dst) * H,), float("nan"), device=cuda)
    before = edge_dots.launches
    k = edge_dots(a, b, d, s, D)
    torch.cuda.synchronize()
    assert edge_dots.launches == before + 1
    assert k.shape == (len(dst), H)
    p = edge_dots_plain(a, b, d, s, D)
    _assert_abs_sum(k, p, edge_dots_plain(a.abs(), b.abs(), d, s, D))
    assert bool((k[torch.from_numpy(dst < 0).to(cuda)] == 0).all())
    if s is not None:
        assert bool((k[-5:] == 0).all())
    for _ in range(3):
        assert torch.equal(edge_dots(a, b, d, s, D), k)


def test_edge_dots_refuse_what_they_do_not_take(cuda):
    a = torch.ones(10, 12, device=cuda)
    d = torch.zeros(5, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="whole heads"):
        edge_dots(a, a, d, None, 5)
    with pytest.raises(ValueError, match="int32"):
        edge_dots(a, a, d.long(), None, 4)
    with pytest.raises(ValueError, match="columns"):
        edge_dots(a, a[:, :8].contiguous(), d, None, 4)
    with pytest.raises(ValueError, match="float32"):
        edge_dots(a.double(), a.double(), d, None, 4)


@pytest.mark.parametrize("N", [1, 8, 32, 100])
@pytest.mark.parametrize("tiles", [(512, 256, 1), (64, 32, 16), (32, 1, 1)])
@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("form", ["values", "gathered"])
def test_pr_both_forms_match_plain(cuda, N, tiles, chunked, form):
    """plan_segment_sum_pr over the plan's row schedule, the plan whole
    (chunked: uniformized chunks, the hub window split, out_block out of
    order as a whole), in the values form (vals_t [N, T*E]) and the
    gathered one (x[src[e]] read in the kernel, x node rows, some past its
    end), weighted, with every fourth slot weight exactly 0 (inside the
    hub row's run); every element written (NaN-filled memory first),
    reruns bit-identical, one launch a plan, the two forms within the rule
    of each other."""
    e_tile, s_tile, pack_align = tiles
    rng = np.random.default_rng(N + e_tile + 2 * chunked + (form == "gathered"))
    n = 1500
    src, dst = _hubby(rng, n, 6000, 3000, hub=9)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    plan = tplan.build_segment_plan(dst, src, n + 400, e_tile=e_tile, s_tile=s_tile,
                                    pack_align=pack_align, device=cuda,
                                    max_chunk_slots=e_tile * 6 if chunked else 4 << 20)
    assert bool(plan.chunks) == chunked
    T, E = plan.num_tiles, plan.e_tile
    w = plan.mask * torch.from_numpy(rng.standard_normal((T, E)).astype(np.float32)).to(cuda)
    w.reshape(-1)[::4] = 0.0
    x = torch.from_numpy(rng.standard_normal((n - 20, N)).astype(np.float32)).to(cuda)
    s = torch.from_numpy(src).to(cuda)
    if form == "gathered":
        v, kw = x, {"src": s}
    else:
        v = tref._rows_or_zero(x, plan.src_slots.reshape(-1).long()).t().contiguous()
        kw = {}
    fn, plain = _SLOT["pr"]
    torch.full((4 * plan.n_blocks * s_tile * max(N, 8),), float("nan"), device=cuda)
    before = fn.launches
    k = fn(plan, v, w, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert k.shape == (N, plan.n_blocks * s_tile)
    a = plain(plan, v.abs(), w.abs(), **kw)
    _assert_abs_sum(k, plain(plan, v, w, **kw), a)
    for _ in range(2):
        assert torch.equal(fn(plan, v, w, **kw), k)
    other = ({"src": s} if form == "values" else {})
    vo = x if form == "values" else tref._rows_or_zero(
        x, plan.src_slots.reshape(-1).long()).t().contiguous()
    _assert_abs_sum(fn(plan, vo, w, **other), k, a)


def test_segment_counts_on_card_one_row(cuda):
    """The mean's degree over a slot plan (s_tile % 128 == 0): one pr launch
    of ones [1, slots], the plan whole (chunked, hub window split),
    integer counts equal to a bincount."""
    rng = np.random.default_rng(4)
    n = 1500
    src, dst = _hubby(rng, n, 6000, 3000, hub=9)
    dst = np.sort(dst)
    exp = torch.from_numpy(np.bincount(dst, minlength=n).astype(np.float32)).to(cuda)
    for mcs in (4 << 20, 512 * 3):
        plan = tplan.build_segment_plan(dst, src, n, e_tile=512, s_tile=256,
                                        max_chunk_slots=mcs, device=cuda)
        before = tslot.plan_segment_sum_pr.launches
        got = api.segment_counts(plan)
        assert tslot.plan_segment_sum_pr.launches == before + 1
        assert torch.equal(got, exp)


@pytest.mark.parametrize("model", ["gat", "slot_dyn"])
def test_weight_gradients_launch_edge_dots(cuda, model):
    """The attention gradient of gat_attention_spmm (per head) and
    slot_dyn's weight gradient run the per-edge dot kernel (`edge_dots`,
    one launch a backward) and equal the CPU's plain dots."""
    from geot_tpu_torch.models import prepare_graph

    rng = np.random.default_rng(31)
    n, H, D = 2000, 4, 7
    src, dst = _hubby(rng, n, 12000, 3000, hub=5)
    kw = dict(add_self_loops=True, e_tile=512, s_tile=256, mode_hint="sr", prefer="sr",
              prefer_dyn="sr", layouts=("slot",))
    res = []
    for dev in (cuda, "cpu"):
        g = prepare_graph(src, dst, n, device=dev, **kw)
        gen = np.random.default_rng(0)
        if model == "gat":
            ins = [torch.from_numpy(gen.standard_normal(sh).astype(np.float32)).to(dev)
                   for sh in ((n, H, D), (n, H), (n, H))]
            co = torch.from_numpy(gen.standard_normal((n, H, D)).astype(np.float32)).to(dev)
            args = [t.clone().requires_grad_() for t in ins]
            before = edge_dots.launches
            out = api.gat_attention_spmm(g, *args)
        else:
            x = torch.from_numpy(gen.standard_normal((n, 24)).astype(np.float32)).to(dev)
            w = torch.from_numpy(gen.random(g.num_edges).astype(np.float32)).to(dev)
            co = torch.from_numpy(gen.standard_normal((n, 24)).astype(np.float32)).to(dev)
            args = [x.clone().requires_grad_(), w.clone().requires_grad_()]
            assert api.dispatch_path(g, dynamic_w=True) == "slot_dyn"
            before = edge_dots.launches
            out = api.gather_weight_scatter(g.src, g.dst, args[1], args[0], n, graph=g)
        torch.vdot(out.reshape(-1), co.reshape(-1)).backward()
        if dev == cuda:
            torch.cuda.synchronize()
            assert edge_dots.launches == before + 1
        res.append([t.grad.cpu() for t in args])
    for gk, gp in zip(*res):
        torch.testing.assert_close(gk, gp, rtol=1e-4, atol=1e-4 * float(gp.abs().max()))


def _bucketed_plan(cuda, bucket_rows, weighted, n=900, nnz=6000, hub_edges=800):
    """A bucketed BAT plan over hubby dst-sorted edges: several buckets and
    uniform chunks (pad tiles on the sentinel block and past n_blocks)."""
    rng = np.random.default_rng(bucket_rows)
    src, dst = _hubby(rng, n, nnz, hub_edges)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    w = rng.standard_normal(len(src)).astype(np.float32) if weighted else None
    bp = tplan.build_bucketed_bat_plan(src, dst, n, n, edge_weight=w, e_tile=64, s_tile=32,
                                       bucket_rows=bucket_rows, max_chunk_tiles=5,
                                       device=cuda)
    assert int(bp.vblock.max()) == bp.n_vblocks and len(bp.chunks) > 3
    return rng, n, bp


@pytest.mark.parametrize("bucket_rows", [64, 160, 1000])
@pytest.mark.parametrize("F", [1, 7, 40, 128, 200])
@pytest.mark.parametrize("weighted", [False, True])
def test_bucketed_sum_matches_plain(cuda, bucket_rows, F, weighted):
    """The edge-row kernel over a bucketed plan (x[src[e]] by global ids,
    the baked weights) against the reference's chunk-order plain version:
    the abs-sum rule, one launch counted under bat_segment_sum, reruns
    bit-identical; x rows past the table's end read as zero."""
    rng, n, bp = _bucketed_plan(cuda, bucket_rows, weighted)
    x = torch.from_numpy(rng.standard_normal((n, F)).astype(np.float32)).to(cuda)
    before = bat_segment_sum.launches
    k = bucketed_sum(bp, x)
    torch.cuda.synchronize()
    assert bat_segment_sum.launches == before + 1
    p = bucketed_sum_plain(bp, x)
    a = bucketed_sum_plain(dataclasses.replace(
        bp, w_pad=None if bp.w_pad is None else bp.w_pad.abs()), x.abs())
    _assert_abs_sum(k, p, a)
    for _ in range(2):
        assert torch.equal(bucketed_sum(bp, x), k)
    short = x[: n - 50]
    _assert_abs_sum(bucketed_sum(bp, short), bucketed_sum_plain(bp, short), a)


@pytest.mark.parametrize("weighted", [False, True])
def test_bucketed_route_on_card_matches_cpu(cuda, weighted):
    """segment_spmm and its x gradient over the bucketed route: one
    bat_segment_sum launch forward and one backward, against the same
    graph on the CPU."""
    rng = np.random.default_rng(3)
    n = 1200
    src, dst = _hubby(rng, n, 9000, 1500)
    w = rng.random(len(src)).astype(np.float32) if weighted else None
    x = rng.standard_normal((n, 96)).astype(np.float32)
    co = rng.standard_normal((n, 96)).astype(np.float32)
    res = []
    for dev in (cuda, "cpu"):
        g = build_graph(src, dst, n, edge_weight=w, layouts=("bat",), bat_e_tile=64,
                        bat_s_tile=32, bucket_table_bytes=1, bucket_rows=300, device=dev)
        assert api.dispatch_path(g) == "bucketed"
        xx = torch.from_numpy(x).to(dev).requires_grad_()
        before = bat_segment_sum.launches
        out = api.segment_spmm(g, xx)
        (out * torch.from_numpy(co).to(dev)).sum().backward()
        if dev == cuda:
            torch.cuda.synchronize()
            assert bat_segment_sum.launches == before + 2
        res.append((out.detach().cpu(), xx.grad.cpu()))
    for k, p in zip(*res):
        torch.testing.assert_close(k, p, **TOL_HUB)


@pytest.mark.parametrize("reduce", ["max", "min", "prod"])
def test_max_min_prod_rerun_bit_identical(cuda, reduce):
    """The plain route of max, min and prod on the card (segment_reduce
    over the sorted runs: no atomics): reruns bit-identical, values and
    gradients, and equal to the CPU's within f32 rounding."""
    rng = np.random.default_rng(4)
    n = 500
    src, dst = _hubby(rng, n, 4000, 60)
    x = rng.uniform(0.9, 1.1, (n, 24)).astype(np.float32)
    w = rng.uniform(0.9, 1.1, len(src)).astype(np.float32)
    runs = []
    for dev in (cuda, cuda, "cpu"):
        g = build_graph(src, dst, n, layouts=("bat",), device=dev)
        xx = torch.from_numpy(x).to(dev).requires_grad_()
        ww = torch.from_numpy(w).to(dev).requires_grad_()
        vv = (torch.from_numpy(x).to(dev)[g.src.long()] * 0.5).requires_grad_()
        out = api.segment_spmm(g, xx, ww, reduce=reduce)
        iscat = api.index_scatter(vv, g.dst, n, reduce=reduce)
        (out.sum() + iscat.sum()).backward()
        runs.append([t.detach().cpu() for t in (out, iscat, xx.grad, ww.grad, vv.grad)])
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(a, b)
    for a, b in zip(runs[0], runs[2]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("weighted", [False, True])
def test_compiler_rewritten_model_on_card_matches_cpu(cuda, weighted):
    """A two-layer GCN in plain PyTorch through the compiler pass: on the
    card both aggregations run bat_segment_sum (two launches forward; two
    over bat_t, and with learned edge weights two sddmm_bat, backward),
    and the output and gradients equal the same pass on the CPU."""
    from geot_tpu_torch.compiler import count_matches, pattern_transform

    rng = np.random.default_rng(8)
    n = 1500
    src, dst = _hubby(rng, n, 12000, 1000)
    x = rng.standard_normal((n, 48)).astype(np.float32)
    w1 = rng.standard_normal((48, 64)).astype(np.float32) * 0.1
    w2 = rng.standard_normal((64, 7)).astype(np.float32) * 0.1
    ew = rng.random(len(src)).astype(np.float32)
    res = []
    for dev in (cuda, "cpu"):
        g = build_graph(src, dst, n, layouts=("bat",), bat_e_tile=128, bat_s_tile=64,
                        device=dev)
        gs, gd = g.src, g.dst

        def gcn2(x, ew, w1, w2):
            h = x @ w1
            msg = h.index_select(0, gs) * ew[:, None] if weighted else h[gs]
            h = torch.zeros(n, 64, device=h.device).index_add_(0, gd, msg)
            h = torch.relu(h) @ w2
            msg = h.index_select(0, gs) * ew[:, None] if weighted else h[gs]
            return torch.zeros(n, 7, device=h.device).index_add_(0, gd, msg)

        args = [torch.from_numpy(a).to(dev).requires_grad_() for a in (x, ew, w1, w2)]
        assert count_matches(gcn2, g, *args) == 2
        before = {k.__name__: k.launches for k in (bat_segment_sum, sddmm_bat)}
        out = pattern_transform(gcn2, g)(*args)
        grads = torch.autograd.grad(out.sum(), args[1:] if weighted else args[2:])
        if dev == cuda:
            torch.cuda.synchronize()
            assert bat_segment_sum.launches - before["bat_segment_sum"] == 4
            assert sddmm_bat.launches - before["sddmm_bat"] == (2 if weighted else 0)
        res.append([out.detach().cpu()] + [t.cpu() for t in grads])
    for k, p in zip(*res):
        torch.testing.assert_close(k, p, **TOL_HUB)


def test_native_plans_on_card_equal_numpy(cuda):
    """The native runtime builds on the card's machine, and a graph built
    through it (slot plans at pack_align 1, BAT, bucketed BAT, both
    sorts) equals the numpy build tensor for tensor, on the card."""
    from geot_tpu_torch import native

    assert native.available()
    rng = np.random.default_rng(9)
    n = 2000
    src, dst = _hubby(rng, n, 20000, 2500)
    w = rng.random(len(src)).astype(np.float32)
    kw = dict(edge_weight=w, layouts=("bat", "slot"), e_tile=128, s_tile=64, bat_e_tile=128,
              bat_s_tile=64, bucket_table_bytes=1, bucket_rows=500, device=cuda)
    g_nat = build_graph(src, dst, n, **kw)
    with native.disabled():
        g_np = build_graph(src, dst, n, **kw)

    def same(a, b, what):
        if isinstance(a, torch.Tensor):
            assert a.is_cuda and torch.equal(a, b), what
        elif dataclasses.is_dataclass(a):
            for f in dataclasses.fields(a):
                if f.name not in ("build_stats", "seconds"):
                    same(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
        elif isinstance(a, (tuple, list)):
            for i, (u, v) in enumerate(zip(a, b)):
                same(u, v, f"{what}.{i}")
        else:
            assert a == b, what

    same(g_nat, g_np, "graph")


def _parallel_case(layout, P):
    """A small graph and partition keywords of each layout (hybrid: part-
    aligned communities, which the per-part census streams)."""
    rng = np.random.default_rng({"slot": 1, "bat": 2, "hybrid": 3}[layout] + P)
    if layout == "hybrid":
        n, npp = 512, 512 // P
        p_of = rng.integers(0, P, 12_000)
        dst = np.concatenate([p_of * npp + rng.integers(0, npp, 12_000),
                              rng.integers(0, n, 1_200)])
        src = np.concatenate([p_of * npp + rng.integers(0, npp, 12_000),
                              rng.integers(0, n, 1_200)])
        kw = dict(s_tile=32, layout="hybrid", bat_e_tile=256, max_chunk_tiles=8)
    else:
        n = 300
        src, dst = _hubby(rng, n, 2000, 600)
        kw = (dict(e_tile=64, s_tile=64) if layout == "slot"
              else dict(s_tile=32, layout="bat", bat_e_tile=32, max_chunk_tiles=4))
    w = rng.standard_normal(len(src)).astype(np.float32)
    return src.astype(np.int32), dst.astype(np.int32), n, w, kw


@pytest.mark.parametrize("layout", ["slot", "bat", "hybrid"])
@pytest.mark.parametrize("F", [128, 40])
def test_part_reduces_on_card_match_plain(cuda, layout, F):
    """Every part's reduces (both directions; the hybrid layout's streamed
    cells into a carry) launch their kernels on the card and match the
    same part's plain route on the CPU; reruns bit-identical."""
    from geot_tpu_torch.parallel import partition_graph
    from geot_tpu_torch.parallel.halo_spmm import _interior_reduce, _reduce

    src, dst, n, w, kw = _parallel_case(layout, 2)
    pg = partition_graph(src, dst, n, 2, edge_weight=w, **kw)
    rng = np.random.default_rng(F)
    counters = (tslot.plan_segment_sum_sr, tslot.plan_segment_sum_sr_packed, bat_segment_sum,
                stream_segment_acc)
    for r in range(2):
        vc, vh = pg.part(r, cuda), pg.part(r, "cpu")
        before = [k.launches for k in counters]
        for fam, rows in (("boundary", 2 * pg.halo), ("boundary_t", pg.nodes_per_part)):
            x = torch.from_numpy(rng.standard_normal((rows, F)).astype(np.float32))
            k = _reduce(getattr(vc, fam), x.to(cuda), "auto")
            torch.cuda.synchronize()
            torch.testing.assert_close(k.cpu(), _reduce(getattr(vh, fam), x, "auto"), **TOL_HUB)
            assert torch.equal(_reduce(getattr(vc, fam), x.to(cuda), "auto"), k)
        x = torch.from_numpy(rng.standard_normal((pg.nodes_per_part, F)).astype(np.float32))
        for t in (False, True):
            k = _interior_reduce(vc, x.to(cuda), "auto", transpose=t)
            torch.testing.assert_close(k.cpu(), _interior_reduce(vh, x, "auto", transpose=t),
                                       **TOL_HUB)
            assert torch.equal(_interior_reduce(vc, x.to(cuda), "auto", transpose=t), k)
        got = [k.launches - b for k, b in zip(counters, before)]
        # four reduces, each run twice
        if layout == "slot":
            want = [8, 0, 0, 0] if F > 64 else [0, 8, 0, 0]
        elif layout == "bat":
            want = [0, 0, 8, 0]
        else:
            want = [0, 0, 8, sum(s is not None for s in (vc.stream, vc.stream_t)) * 2]
        assert got == want, (r, got, want)


@functools.lru_cache(maxsize=None)
def _two_ranks(device):
    from geot_tpu_torch.parallel import spawn_ranks
    from torch_parallel_worker import halo_cases

    cases = []
    for layout in ("slot", "bat", "hybrid"):
        src, dst, n, w, kw = _parallel_case(layout, 2)
        rng = np.random.default_rng(5)
        cases.append(dict(name=layout, src=src, dst=dst, num_nodes=n, w=w, kw=kw,
                          x=rng.standard_normal((n, 40)).astype(np.float32),
                          cot=rng.standard_normal((n, 40)).astype(np.float32),
                          backends=("auto",)))
    return spawn_ranks(halo_cases, 2, cases, device, timeout=300.0)


@pytest.mark.parametrize("layout", ["slot", "bat", "hybrid"])
def test_halo_spmm_two_gloo_ranks_on_card(cuda, layout):
    """halo_spmm forward and x gradient in a 2-rank gloo group on cuda:0
    (the exchange staged through the host by gloo) against the same ranks
    on the CPU."""
    on_card, on_cpu = _two_ranks("cuda"), _two_ranks("cpu")
    for rc, rh in zip(on_card, on_cpu):
        for k_, h_ in zip(rc[(layout, "auto")], rh[(layout, "auto")]):
            torch.testing.assert_close(torch.from_numpy(k_), torch.from_numpy(h_), **TOL_HUB)


@pytest.mark.parametrize("F", [128, 40])
def test_sums_over_plans_without_edges(cuda, F):
    """A plan with no edge (a part's boundary plans in a 1-part partition,
    the plans of a part that has no edges) launches and writes zeros: an
    empty schedule's slot array is a null pointer, which the kernel must
    not refuse."""
    none = np.zeros(0, np.int32)
    plan = tplan.build_segment_plan(none, none, 100, e_tile=64, s_tile=32, device=cuda)
    bp = tplan.build_bat_plan(none, 100, e_tile=64, s_tile=32, device=cuda)
    x = torch.randn(10, F, device=cuda)
    src = torch.zeros(0, dtype=torch.int32, device=cuda)
    fn = tslot.plan_segment_sum_sr if F > 64 else tslot.plan_segment_sum_sr_packed
    before = fn.launches
    out = fn(plan, x, plan.mask, src=src)
    assert fn.launches == before + 1
    assert out.shape == (plan.n_blocks * 32, F) and not out.any()
    out = bat_segment_sum(bp, x, None, src=src)
    assert out.shape == (bp.n_blocks * 32, F) and not out.any()


@pytest.mark.parametrize("entry", ["node_terms", "logits"])
@pytest.mark.parametrize("graph,H", [("small", 1), ("small", 3), ("small", 8), ("cell", 3)])
def test_edge_softmax_matches_plain(cuda, graph, H, entry):
    """The edge softmax kernel (forward: main pass and the cut rows'
    fix-up; backward: the dst pass, its fix-up, the src pass and the cut
    rows' sums) against its plain version on the card in float64 from the
    same float32 inputs: att within 1e-6 relative per element (the f32
    logits' rounding in exp's argument, expf's and the row sums'), both
    gradients within 1e-5 of their largest element (sums of up to 71,237
    f32 terms; the plain version in float32 sums them with index_add_'s
    atomics, in any order, and lies further off float64 than that); one
    counted launch a call, reruns bit-identical. Graphs: a small one with
    a 4,000-edge hub row (cut into 16 chunks), empty rows and a
    pre-activation exactly 0, at 1, 3 and 8 heads, and the benchmark
    cell's at its 3 heads."""
    from geot_tpu_torch.models import prepare_graph
    from geot_tpu_torch.ops.softmax_kernels import (
        edge_softmax,
        edge_softmax_grad,
        edge_softmax_grad_plain,
        edge_softmax_plain,
    )

    if graph == "cell":
        from chip_smoke import softmax_graph  # the arxiv-gat cell's graph

        g = softmax_graph(cuda)
        assert int(torch.diff(g.dst_ptr).max()) == 71_237
    else:
        rng = np.random.default_rng(H)
        n = 3000
        src, dst = _hubby(rng, n - 200, 20000, 4000, hub=5)
        g = prepare_graph(src, dst, n, add_self_loops=False, layouts=("slot",), e_tile=512,
                          s_tile=256, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(H)
    E, n = g.num_edges, g.num_nodes
    a_s = 0.5 * torch.randn(n, H, generator=gen, device=cuda)
    a_d = 0.5 * torch.randn(n, H, generator=gen, device=cuda)
    a_s[int(g.src[0])] = -a_d[int(g.dst[0])]
    lg = 0.7 * torch.randn(E, H, generator=gen, device=cuda)
    gg = torch.randn(E, H, generator=gen, device=cuda)
    node = entry == "node_terms"
    kw = dict(alpha_src=a_s, alpha_dst=a_d, src=g.src) if node else {}
    logits = None if node else lg
    runs = dict(perm_t=g.perm_t, src_t=g.src.index_select(0, g.perm_t.long()),
                src_ptr=g.src_ptr)
    tkw = dict(kw, **runs) if node else {}
    before = edge_softmax.launches, edge_softmax_grad.launches
    att = edge_softmax(g.dst, g.dst_ptr, logits, **kw)
    grads = edge_softmax_grad(g.dst, g.dst_ptr, att, gg, **tkw)
    torch.cuda.synchronize()
    assert (edge_softmax.launches, edge_softmax_grad.launches) == (before[0] + 1,
                                                                   before[1] + 1)
    kw64 = {k: v.double() if v.is_floating_point() else v for k, v in kw.items()}
    p = edge_softmax_plain(g.dst, g.dst_ptr, None if node else lg.double(), **kw64)
    rel = ((att - p).abs() / p.abs().clamp(min=1e-30)).max()
    assert float(rel) <= 1e-6, float(rel)
    tkw64 = dict(tkw, **kw64)
    want = edge_softmax_grad_plain(g.dst, g.dst_ptr, att.double(), gg.double(), **tkw64)
    grads, want = (grads, want) if node else ((grads,), (want,))
    for k, w in zip(grads, want):
        err = (k - w).abs().max() / w.abs().max()
        assert float(err) <= 1e-5, float(err)
    for _ in range(2):
        again = edge_softmax(g.dst, g.dst_ptr, logits, **kw)
        g2 = edge_softmax_grad(g.dst, g.dst_ptr, again, gg, **tkw)
        g2 = g2 if node else (g2,)
        assert torch.equal(again, att) and all(torch.equal(a, b) for a, b in zip(g2, grads))


def test_edge_softmax_refuses_what_it_does_not_take(cuda):
    """dtype, shape and device of every index and value."""
    from geot_tpu_torch.ops.softmax_kernels import edge_softmax, edge_softmax_grad

    dst = torch.tensor([0, 0, 1, 3], dtype=torch.int32, device=cuda)
    ptr = torch.tensor([0, 2, 3, 3, 4], dtype=torch.int32, device=cuda)
    lg = torch.randn(4, 2, device=cuda)
    with pytest.raises(ValueError, match="dst_ptr must be torch.int32"):
        edge_softmax(dst, ptr.long(), lg)
    with pytest.raises(ValueError, match="logits must be torch.float32"):
        edge_softmax(dst, ptr, lg.double())
    with pytest.raises(ValueError, match="dst must be torch.int32"):
        edge_softmax(dst.long(), ptr, lg)
    with pytest.raises(ValueError, match="alpha_dst must have shape"):
        edge_softmax(dst, ptr, alpha_src=torch.randn(4, 2, device=cuda),
                     alpha_dst=torch.randn(3, 2, device=cuda), src=dst)
    with pytest.raises(ValueError, match="is on cpu"):
        edge_softmax(dst, ptr, lg.cpu())
    att = edge_softmax(dst, ptr, lg)
    torch.testing.assert_close(att[:2].sum(0), torch.ones(2, device=cuda))
    with pytest.raises(ValueError, match="g must have shape"):
        edge_softmax_grad(dst, ptr, att, torch.randn(4, 3, device=cuda))


def test_softmax_routes_take_float64(cuda):
    """`segment_softmax` and `gat_attention_spmm` over float64 tensors on
    the card: the edge softmax kernel runs them in float32 (as `mh_spmm`'s
    kernel does) and hands back float64, within float32's rounding of the
    reference route in float64, forward and gradients; one counted launch
    each way a call."""
    from geot_tpu_torch.models import prepare_graph
    from geot_tpu_torch.ops.softmax_kernels import edge_softmax, edge_softmax_grad

    rng = np.random.default_rng(64)
    n, H, D = 3000, 3, 8
    src, dst = _hubby(rng, n - 200, 20000, 4000, hub=5)
    g = prepare_graph(src, dst, n, add_self_loops=False, layouts=("slot",), e_tile=512,
                      s_tile=256, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(64)
    f64 = dict(generator=gen, device=cuda, dtype=torch.float64)
    lg, co_e = torch.randn(g.num_edges, H, **f64), torch.randn(g.num_edges, H, **f64)
    xh, a_s, a_d = torch.randn(n, H, D, **f64), torch.randn(n, H, **f64), torch.randn(n, H, **f64)
    co = torch.randn(n, H, D, **f64)

    def softmax(lg_, backend="auto"):
        if backend == "reference":
            return tref.segment_softmax_ref(lg_, g.dst, n)
        return api.segment_softmax(lg_, g.dst, n)

    cases = ((softmax, [lg], co_e),
             (functools.partial(api.gat_attention_spmm, g), [xh, a_s, a_d], co))
    for fn, inputs, cot in cases:
        outs = []
        for kw in ({}, {"backend": "reference"}):
            args = [t.clone().requires_grad_() for t in inputs]
            before = edge_softmax.launches, edge_softmax_grad.launches
            out = fn(*args, **kw)
            torch.vdot(out.reshape(-1), cot.reshape(-1)).backward()
            torch.cuda.synchronize()
            ran = (edge_softmax.launches - before[0], edge_softmax_grad.launches - before[1])
            assert ran == ((1, 1) if not kw else (0, 0)), ran
            assert out.dtype == torch.float64 and all(t.grad.dtype == torch.float64
                                                      for t in args)
            outs.append((out.detach(), [t.grad for t in args]))
        (o_k, g_k), (o_r, g_r) = outs
        torch.testing.assert_close(o_k, o_r, rtol=1e-5, atol=1e-5 * float(o_r.abs().max()))
        for a, b in zip(g_k, g_r):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


def test_gcn_aggregate_first_step_on_card(cuda):
    """OGB products' GCN widths (100 -> 256 -> 256 -> 47) over a hybrid
    graph of ~4.1 M edges (products' shape at 60,000 nodes: communities of
    ~2,000, 30% of edges across, Zipf(0.5) in-degrees, both directions; the
    census's margin waived at this size). The first layer widens, so it
    sums first and recomputes its sum in the backward. One training step
    against the multiply-first form written out here: the same hybrid
    launches (six sums a step); the step's peak device memory no higher;
    each leaf's gradient no farther from a float64 step (`torch.sparse.mm`
    over the same weights, through the form's own ReLU pattern: ROADMAP
    C.10) than twice the multiply-first form's distance from its float64
    step (ROADMAP C.19's rule), or the products configuration's `grad_gap`
    limit 5e-6 of the leaf's float64 norm."""
    import torch.nn.functional as F

    from geot_tpu_torch.graph.datasets import synthetic_clustered_graph
    from geot_tpu_torch.models import prepare_graph

    n = 60_000
    d = synthetic_clustered_graph(n, 2_000_000, mixing=0.3, mean_community=2000, power=0.5,
                                  seed=24)
    src, dst = np.concatenate([d.src, d.dst]), np.concatenate([d.dst, d.src])
    g = prepare_graph(src, dst, n, normalize="gcn", layouts=("bat", "stream"),
                      stream_knobs=tsp.StreamKnobs(margin=1.0), device=cuda)
    assert api.dispatch_path(g) == "hybrid"
    gen = torch.Generator(device=cuda).manual_seed(24)
    x = torch.randn(n, 100, generator=gen, device=cuda)
    y = torch.randint(0, 47, (n,), generator=gen, device=cuda)
    model = GCN(100, 256, 3, 47, conv_kwargs={"normalize": False},
                generator=torch.Generator().manual_seed(24), device=cuda)
    assert [c.aggregate_first for c in model.convs] == [True, False, False]
    with torch.no_grad():
        for c in model.convs:
            c.bias.copy_(0.1 * torch.randn(c.bias.shape, generator=gen, device=cuda))
    lin = {k: p.detach().clone().requires_grad_() for k, p in model.named_parameters()}
    masks = {"program": {}, "linear_first": {}}  # the hidden layers' ReLU patterns

    def linear_first(p, h, keep=None):
        for i in range(3):
            h = api.segment_spmm(g, F.linear(h, p[f"convs.{i}.lin.weight"]))
            h = h + p[f"convs.{i}.bias"]
            if i < 2:
                if keep is not None:
                    keep[i] = h.detach() > 0
                h = torch.relu(h)
        return h

    def step_program():
        model.zero_grad(set_to_none=True)
        F.cross_entropy(model(x, g), y).backward()

    def step_linear_first(keep=None):
        for p in lin.values():
            p.grad = None
        F.cross_entropy(linear_first(lin, x, keep), y).backward()

    def run(step):
        """(stream launches, peak bytes above the resident) of one step."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        before = stream_segment_sum.launches
        step()
        torch.cuda.synchronize()
        return stream_segment_sum.launches - before, torch.cuda.max_memory_allocated() - resident

    for step in (step_program, step_linear_first):  # warm up
        step()
    launches_p, peak_p = run(step_program)
    launches_l, peak_l = run(step_linear_first)
    assert launches_p == launches_l == 6
    assert peak_p <= peak_l, (peak_p, peak_l)

    # the gradients again, with each form's ReLU pattern kept
    hooks = [c.register_forward_hook(
        lambda mod, inp, out, i=i: masks["program"].__setitem__(i, out.detach() > 0))
        for i, c in enumerate(model.convs[:2])]
    step_program()
    for h in hooks:
        h.remove()
    step_linear_first(masks["linear_first"])
    a64 = torch.sparse_coo_tensor(torch.stack([g.dst.long(), g.src.long()]),
                                  g.edge_weight.double(), (n, n)).coalesce()

    def grads64(keep):
        p64 = {k: v.detach().double().requires_grad_() for k, v in lin.items()}
        h = x.double()
        for i in range(3):
            h = torch.sparse.mm(a64, F.linear(h, p64[f"convs.{i}.lin.weight"]))
            h = h + p64[f"convs.{i}.bias"]
            if i < 2:
                h = h * keep[i]
        F.cross_entropy(h, y).backward()
        return {k: p.grad for k, p in p64.items()}

    ref_p, ref_l = grads64(masks["program"]), grads64(masks["linear_first"])
    for k, p in model.named_parameters():
        e_prog = float((p.grad.double() - ref_p[k]).norm() / ref_p[k].norm())
        e_lin = float((lin[k].grad.double() - ref_l[k]).norm() / ref_l[k].norm())
        assert e_prog <= max(2 * e_lin, 5e-6), (k, e_prog, e_lin)
