"""The CUDA kernel on the card against its plain version.

Marked `gpu`; each test skips without a card (decided inside the fixture,
so every pytest worker collects the same tests). The machine with the card
has no JAX, so this file imports none, and it is run there without the
suite's conftest (which sets JAX up):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerance: the kernel sums each row in edge order in f32, the plain
version with `index_add_` (atomics on the card, so any order): f32 sums of
the same terms in two orders, rows of up to ~1500 terms of magnitude ~1,
so rtol/atol 1e-4 (the reference's own hub-split bound, test_ops.py:362).
"""

import dataclasses

import numpy as np
import pytest
import torch

from geot_tpu_torch.graph import plan as tplan
from geot_tpu_torch.graph.structures import build_graph
from geot_tpu_torch.models import GCN
from geot_tpu_torch.ops import api
from geot_tpu_torch.ops.bat_kernels import bat_segment_sum, bat_segment_sum_plain

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


@pytest.mark.parametrize("f_pad", [128, 256])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("e_tile,s_tile", [(64, 32), (1024, 256), (32, 4), (96, 8), (32, 1)])
def test_kernel_matches_plain(cuda, f_pad, weighted, e_tile, s_tile):
    rng = np.random.default_rng(f_pad + weighted + e_tile)
    n = 700
    _, dst = _hubby(rng, n, 5000, 1500)
    dst = np.sort(dst)
    nnz = len(dst)
    bp = tplan.build_bat_plan(dst, n + 300, e_tile=e_tile, s_tile=s_tile, device=cuda)
    vals = torch.from_numpy(rng.standard_normal((nnz, f_pad)).astype(np.float32)).to(cuda)
    w = (torch.from_numpy(rng.standard_normal(nnz).astype(np.float32)).to(cuda)
         if weighted else None)
    # leave NaN in the memory the caching allocator hands out next, so a
    # row the kernel fails to write shows
    torch.full((bp.n_blocks * s_tile + 4 * bp.num_tiles, f_pad), float("nan"), device=cuda)
    before = bat_segment_sum.launches
    k = bat_segment_sum(bp, vals, w, f_tile=256 if f_pad == 256 else 128)
    torch.cuda.synchronize()
    assert bat_segment_sum.launches == before + 1
    p = bat_segment_sum_plain(bp, vals, w)
    assert k.shape == p.shape == (bp.n_blocks * s_tile, f_pad)
    torch.testing.assert_close(k, p, **TOL_HUB)
    # deterministic: no atomics, bit-identical rerun
    torch.testing.assert_close(bat_segment_sum(bp, vals, w), k, rtol=0, atol=0)


def test_segment_spmm_chunked_hub_on_card(cuda):
    rng = np.random.default_rng(61)
    n, F = 100, 40
    src, dst = _hubby(rng, n, 400, 1500, hub=3)
    w = rng.standard_normal(len(dst)).astype(np.float32)
    kw = dict(bat_e_tile=32, bat_s_tile=32, max_chunk_bytes=8 * 32 * 128 * 4)
    gc = build_graph(src, dst, n, edge_weight=w, device=cuda, **kw)
    gh = build_graph(src, dst, n, edge_weight=w, device="cpu", **kw)
    assert len(gc.bat.chunks) > 2
    x = rng.standard_normal((n, F)).astype(np.float32)
    before = bat_segment_sum.launches
    with torch.inference_mode():
        out = api.segment_spmm(gc, torch.from_numpy(x).to(cuda))
        exp = api.segment_spmm(gh, torch.from_numpy(x))
    assert bat_segment_sum.launches == before + len(gc.bat.chunks)
    torch.testing.assert_close(out.cpu(), exp, **TOL_HUB)
    ch = tplan.compute_chunks(gh.bat.out_block.numpy(), 8)
    g2 = dataclasses.replace(gc, bat=tplan.with_chunks(gc.bat, ch))
    with torch.inference_mode():
        out2 = api.segment_spmm(g2, torch.from_numpy(x).to(cuda))
    torch.testing.assert_close(out2.cpu(), exp, **TOL_HUB)


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
