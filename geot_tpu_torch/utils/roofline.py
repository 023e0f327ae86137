"""Bytes model and roofline share of the segment-reduction ops.

Port of `geot_tpu/utils/roofline.py` (`spmm_bytes`, `sddmm_bytes`,
`roofline_fraction`, `hbm_bandwidth_gbps`). The bytes models are the
reference's. The memory rate is the card's published peak; a card not in
the table raises, and no TPU figure stands in for it.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["spmm_bytes", "sddmm_bytes", "hbm_bandwidth_gbps", "roofline_fraction"]

# published peak memory rate (GB/s) by a lowercase piece of the card's name:
# the H100 SXM, 80 GB HBM3 at 3.35 TB/s (NVIDIA's data sheet); its PCIe and
# NVL parts have other rates and are not in the table
_HBM_GBPS = (
    ("h100 80gb hbm3", 3350.0),
    ("h100 sxm", 3350.0),
)


def hbm_bandwidth_gbps(device: Optional[Union[str, int, torch.device]] = None) -> float:
    """Peak memory rate of the card `device` (default: the current CUDA
    card), or of a card named by a string such as
    `torch.cuda.get_device_name()` gives. Raises ValueError for a card not
    in the table."""
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        name = device
    else:
        name = torch.cuda.get_device_name(device)
    low = name.lower()
    for key, gbps in _HBM_GBPS:
        if key in low:
            return gbps
    raise ValueError(f"no published memory rate for {name!r}: add it to _HBM_GBPS")


def spmm_bytes(
    nnz: int,
    n_features: int,
    num_segments: int,
    num_src_nodes: int,
    dtype_bytes: int = 4,
    weighted: bool = True,
    fused_gather: bool = False,
) -> int:
    """Least memory traffic of out[dst[e]] += w[e] * x[src[e]]: each
    gathered row read once per edge, the index (and weight) streams once,
    the output written once; with `fused_gather=False` the edge rows also
    cross memory twice more (a gather written and read back before the
    sum). The port's kernels read x[src[e]] themselves: `fused_gather=True`
    is their model. `num_src_nodes` is the reference's argument and enters
    nothing."""
    del num_src_nodes
    row_bytes = n_features * dtype_bytes
    traffic = nnz * row_bytes
    if fused_gather is False:
        traffic += 2 * nnz * row_bytes
    traffic += nnz * 4 * (2 if weighted else 1)
    traffic += num_segments * row_bytes
    return traffic


def sddmm_bytes(nnz: int, n_features: int, dtype_bytes: int = 4) -> int:
    """Least memory traffic of out[e] = <a[dst[e]], b[src[e]]>: two rows
    and two indices read per edge, one value written."""
    return nnz * (2 * n_features * dtype_bytes + 2 * 4 + dtype_bytes)


def roofline_fraction(time_s: float, bytes_moved: int, device=None) -> float:
    """The share of the card's peak memory rate that `bytes_moved` in
    `time_s` seconds reaches."""
    return (bytes_moved / time_s) / (hbm_bandwidth_gbps(device) * 1e9)
