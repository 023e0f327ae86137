"""Plain-torch oracles for the fused gather(-weight)-scatter ops.

Port of `geot_tpu/ops/reference.py:37-105` (`segment_reduce_ref` for sum
and mean, `gather_scatter_ref`, `gather_weight_scatter_ref`) and `:117-127`
(`sddmm_coo_ref`). They share no code with the tiled path, so tests hold
that path against them.
"""

from __future__ import annotations

import torch

__all__ = [
    "segment_reduce_ref",
    "gather_scatter_ref",
    "gather_weight_scatter_ref",
    "sddmm_coo_ref",
]

VALID_REDUCE = ("sum", "mean")


def segment_reduce_ref(
    src: torch.Tensor, index: torch.Tensor, num_segments: int, reduce: str = "sum"
) -> torch.Tensor:
    """out[index[i]] += src[i] along axis 0 (sum or mean). Indices outside
    [0, num_segments) are dropped."""
    if reduce not in VALID_REDUCE:
        raise NotImplementedError(
            f"reduce={reduce!r}: only sum and mean are ported (ROADMAP A.7)"
        )
    index = index.long()
    keep = (index >= 0) & (index < num_segments)
    idx, vals = index[keep], src[keep]
    out = torch.zeros((num_segments,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    out.index_add_(0, idx, vals)
    if reduce == "mean":
        cnt = torch.zeros(num_segments, dtype=src.dtype, device=src.device)
        cnt.index_add_(0, idx, torch.ones_like(idx, dtype=src.dtype))
        out = out / torch.clamp(cnt, min=1).reshape((-1,) + (1,) * (src.dim() - 1))
    return out


def gather_scatter_ref(
    src_index: torch.Tensor,
    dst_index: torch.Tensor,
    src: torch.Tensor,
    num_segments: int,
    reduce: str = "sum",
) -> torch.Tensor:
    """out[dst[e]] += src[src[e]] — unweighted fused SpMM."""
    return segment_reduce_ref(src[src_index.long()], dst_index, num_segments, reduce)


def gather_weight_scatter_ref(
    src_index: torch.Tensor,
    dst_index: torch.Tensor,
    weight: torch.Tensor,
    src: torch.Tensor,
    num_segments: int,
    reduce: str = "sum",
) -> torch.Tensor:
    """out[dst[e]] += weight[e] * src[src[e]]."""
    vals = src[src_index.long()] * weight[:, None].to(src.dtype)
    return segment_reduce_ref(vals, dst_index, num_segments, reduce)


def sddmm_coo_ref(
    src_index: torch.Tensor,
    dst_index: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
) -> torch.Tensor:
    """Per-edge dot product: out[e] = <a[dst[e]], b[src[e]]> (the weight
    gradient of gather_weight_scatter)."""
    return (a[dst_index.long()] * b[src_index.long()]).sum(dim=-1)
