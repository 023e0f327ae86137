"""Graph container with prebuilt BAT plans.

Port of `geot_tpu/graph/structures.py` (`Graph` :45-121, `_stable_sort_perm`
:122-131, `build_graph` :140-397) for `layouts=("bat",)`. The JAX builder
asks its TPU tuning table for tiles unless all are given; the port reads
no table and takes every tile explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from geot_tpu_torch.graph.plan import (
    MAX_PREFETCH_TILES,
    BatPlan,
    build_bat_plan,
    packed_width,
)
from geot_tpu_torch.utils.device import resolve_device

__all__ = ["Graph", "build_graph"]


@dataclasses.dataclass(frozen=True)
class Graph:
    """dst-sorted COO adjacency + BAT plans (torch tensors on one device).

    src, dst: [nnz] int32, sorted by dst ascending.
    edge_weight: [nnz] float32 or None — static per-edge weights.
    bat / bat_t: forward plan (reduce over dst) and transpose plan (reduce
      over src, edges sorted by src; drives the backward of every fused
      SpMM).
    perm_t: [nnz] int32 — dst-sorted position of the e-th src-sorted edge.
    dst_t, edge_weight_t: dst[perm_t], edge_weight[perm_t].
    The reference's slot-layout fields (plan, w_slots, ...) are absent: the
    slot layout is not ported (ROADMAP A.9).
    """

    src: torch.Tensor
    dst: torch.Tensor
    edge_weight: Optional[torch.Tensor]
    bat: Optional[BatPlan]
    bat_t: Optional[BatPlan]
    perm_t: torch.Tensor
    dst_t: torch.Tensor
    edge_weight_t: Optional[torch.Tensor]
    num_nodes: int = 0

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device


def _stable_sort_perm(key: np.ndarray) -> np.ndarray:
    """Stable sort permutation of `key` (the reference uses a native
    counting sort when built; a stable permutation is unique, so both give
    the same array)."""
    return np.argsort(np.asarray(key), kind="stable")


def build_graph(
    src,
    dst,
    num_nodes: int,
    edge_weight=None,
    *,
    e_tile: int = 512,
    s_tile: int = 256,
    bat_e_tile: int = 1024,
    bat_s_tile: int = 256,
    feature_hint: int = 128,
    assume_sorted: bool = False,
    layouts: Tuple[str, ...] = ("bat",),
    max_chunk_bytes: int = 1 << 30,
    device=None,
) -> Graph:
    """Host-side preprocessing: sort by dst, build forward + transpose BAT
    plans, move everything to `device` (default: the CUDA card).

    Tiles are explicit. The defaults bat_e_tile=1024, bat_s_tile=256 are
    the reference's TPU picks and are not measured on H100. `e_tile` and
    `s_tile` size the slot layout, which is not ported; they are accepted
    so call sites match the reference. `max_chunk_bytes` caps one chunk's
    gathered [tiles*bat_e_tile, feature_hint] f32 block (the reference's
    GEOT_MAX_CHUNK_BYTES budget, `structures.py:257`).
    """
    del e_tile, s_tile  # slot layout only (ROADMAP A.9)
    if tuple(layouts) != ("bat",):
        raise NotImplementedError(
            f"layouts={tuple(layouts)!r}: only ('bat',) is ported; slot layout "
            "is ROADMAP A.9, stream/hybrid is ROADMAP A.4"
        )
    if feature_hint and packed_width(feature_hint):
        raise NotImplementedError(
            f"feature_hint={feature_hint} asks for packed narrow-feature plans, "
            "not ported yet (ROADMAP A.5 / B.3); use feature_hint >= 65"
        )
    dev = resolve_device(device)
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    if edge_weight is not None:
        edge_weight = np.asarray(edge_weight, dtype=np.float32)
    if not assume_sorted:
        order = _stable_sort_perm(dst)
        src, dst = src[order], dst[order]
        if edge_weight is not None:
            edge_weight = edge_weight[order]
    perm_t = _stable_sort_perm(src)
    src_t = src[perm_t]
    # chunk cap by gather bytes (reference structures.py:245-260)
    row_b = max(feature_hint if feature_hint else 128, 1) * 4
    mct = max(min(MAX_PREFETCH_TILES, max_chunk_bytes // (row_b * bat_e_tile)), 1)
    kw = dict(e_tile=bat_e_tile, s_tile=bat_s_tile, max_chunk_tiles=mct, device=dev)
    bat = build_bat_plan(dst, num_nodes, **kw)
    bat_t = build_bat_plan(src_t, num_nodes, **kw)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return Graph(
        src=t(src),
        dst=t(dst),
        edge_weight=None if edge_weight is None else t(edge_weight),
        bat=bat,
        bat_t=bat_t,
        perm_t=t(perm_t.astype(np.int32)),
        dst_t=t(dst[perm_t]),
        edge_weight_t=None if edge_weight is None else t(edge_weight[perm_t]),
        num_nodes=int(num_nodes),
    )
