"""The plain references: their pieces against dense autograd, and each
configuration's reference against the program's CPU path on a small
graph, through a whole run of the harness."""

import time

import numpy as np
import pytest
import torch

from gnnbench.harness.cell import run_cell
from gnnbench.harness.manifest import load_cell
from gnnbench.reference.common import _tf32, edge_sum, ref_graph


def test_edge_sum_and_its_gradients_match_dense():
    gen = torch.Generator().manual_seed(0)
    src = np.array([0, 1, 2, 2, 3, 0, 3], np.int32)
    dst = np.array([1, 1, 0, 3, 3, 2, 1], np.int32)
    g = ref_graph(src, dst, 4, self_loops=True, normalize="gcn", device="cpu")
    assert g.num_edges == 9  # the two loops replaced by the full diagonal
    adj = torch.zeros(4, 4, dtype=torch.float64)
    adj[g.dst, g.src] = g.weight.double()
    deg = torch.tensor([2.0, 3.0, 2.0, 2.0], dtype=torch.float64)  # in-degrees with loops
    assert torch.allclose(adj[1, 3], 1 / torch.sqrt(deg[1] * deg[3]))
    assert torch.allclose(adj[1, 1], 1 / deg[1])
    x = torch.randn(4, 5, generator=gen, dtype=torch.float64, requires_grad=True)
    g.weight = g.weight.double()
    out = edge_sum(g, x)
    assert torch.allclose(out, adj @ x)
    (gx,) = torch.autograd.grad((out ** 2).sum(), x)
    assert torch.allclose(gx, adj.t() @ (2 * (adj @ x)))
    # per-head attention and both gradients
    xh = torch.randn(4, 2, 3, generator=gen, dtype=torch.float64, requires_grad=True)
    att = torch.rand(g.num_edges, 2, generator=gen, dtype=torch.float64, requires_grad=True)
    out = edge_sum(g, xh, att)
    dense = torch.zeros(4, 2, 3, dtype=torch.float64).index_add(
        0, g.dst, att[:, :, None] * xh[g.src])
    assert torch.allclose(out, dense)
    assert torch.autograd.gradcheck(lambda a, v: edge_sum(g, v, a), (att, xh))


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11 + 2.0 ** -12, 3.0e-30, -7.25])
    r = _tf32(x)
    assert r[0] == 1.0 + 2.0 ** -10
    assert r[1] == 1.0 + 2.0 ** -10  # rounded up to the nearest 10-bit mantissa
    assert r[3] == -7.25
    assert (r.view(torch.int32) & 0x1FFF == 0).all()


@pytest.mark.parametrize("cell", ["tiny-gcn.train", "tiny-gcn.serve",
                                  "tiny-ogbn-arxiv-gat.train", "tiny-ogbn-arxiv-gat.serve"])
def test_the_reference_agrees_with_the_programs_cpu_path(checkout, cell):
    c = load_cell(checkout, cell)
    r = run_cell(c, 2**31 + 17, 0.3, False, torch.device("cpu"), time.perf_counter(), None)
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) >= {"setup_s", "peak_mem_gib"}
    for name, chk in r["checks"].items():
        assert chk["value"] < 1e-5, (name, chk)
