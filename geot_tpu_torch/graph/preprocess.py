"""Graph format preprocessing: CSR/COO conversion, sorting, self-loops,
degree, GCN norm.

Port of `geot_tpu/graph/preprocess.py` (`coo_to_csr`, `csr_to_coo`,
`sort_edges_by_dst`, `add_self_loops`, `degree`, `gcn_norm`) in torch. Inputs may be torch
tensors or numpy arrays; outputs are torch tensors on the inputs' device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["coo_to_csr", "csr_to_coo", "sort_edges_by_dst", "add_self_loops", "degree",
           "gcn_norm"]


def _t(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def coo_to_csr(row, num_rows: int) -> torch.Tensor:
    """Row indices (any order) -> CSR row pointer [num_rows + 1] int32: a
    histogram and its exclusive cumsum. Rows outside [0, num_rows) are
    dropped."""
    row = _t(row).long()
    row = row[(row >= 0) & (row < num_rows)]
    hist = torch.bincount(row, minlength=num_rows)
    return torch.cat([hist.new_zeros(1), torch.cumsum(hist, 0)]).to(torch.int32)


def csr_to_coo(indptr, nnz: int) -> torch.Tensor:
    """CSR row pointer -> the row of each of the nnz nonzeros [nnz] int32
    (dst-sorted by construction): the pointer values <= e, less one."""
    indptr = _t(indptr)
    e = torch.arange(nnz, dtype=indptr.dtype, device=indptr.device)
    return (torch.searchsorted(indptr, e, right=True) - 1).to(torch.int32)


def sort_edges_by_dst(src, dst, *edge_attrs) -> Tuple[torch.Tensor, ...]:
    """Stable-sort edges by destination (the contract every fused op
    assumes)."""
    src, dst = _t(src), _t(dst)
    perm = torch.sort(dst, stable=True).indices
    out = [src[perm], dst[perm]]
    out.extend(_t(a)[perm] for a in edge_attrs)
    return tuple(out)


def add_self_loops(
    src,
    dst,
    num_nodes: int,
    edge_weight=None,
    fill_value: float = 1.0,
) -> Tuple[torch.Tensor, ...]:
    """Append (i, i) for every node. Result is NOT sorted."""
    src, dst = _t(src), _t(dst)
    loop = torch.arange(num_nodes, dtype=src.dtype, device=src.device)
    src = torch.cat([src, loop])
    dst = torch.cat([dst, loop])
    if edge_weight is not None:
        edge_weight = _t(edge_weight)
        w = torch.cat(
            [edge_weight, torch.full((num_nodes,), fill_value,
                                     dtype=edge_weight.dtype,
                                     device=edge_weight.device)]
        )
        return src, dst, w
    return src, dst


def degree(index, num_nodes: int, dtype=torch.float32) -> torch.Tensor:
    """In-degree count per node (indices outside [0, num_nodes) dropped)."""
    index = _t(index).long()
    keep = (index >= 0) & (index < num_nodes)
    out = torch.zeros(num_nodes, dtype=dtype, device=index.device)
    return out.index_add_(0, index[keep], torch.ones_like(index[keep], dtype=dtype))


def gcn_norm(
    src,
    dst,
    num_nodes: int,
    edge_weight=None,
    add_loops: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GCN symmetric normalization w_e <- d_dst^-1/2 * w_e * d_src^-1/2,
    with self-loops. Returns (src, dst, weight), unsorted."""
    src, dst = _t(src), _t(dst)
    if edge_weight is None:
        edge_weight = torch.ones(src.shape[0], dtype=torch.float32, device=src.device)
    edge_weight = _t(edge_weight)
    if add_loops:
        src, dst, edge_weight = add_self_loops(src, dst, num_nodes, edge_weight)
    deg = torch.zeros(num_nodes, dtype=edge_weight.dtype, device=edge_weight.device)
    deg.index_add_(0, dst.long(), edge_weight)
    dinv = torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-12)),
                       torch.zeros_like(deg))
    return src, dst, dinv[dst.long()] * edge_weight * dinv[src.long()]
