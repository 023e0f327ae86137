"""Graph container with prebuilt BAT and hybrid stream+gather plans.

Port of `geot_tpu/graph/structures.py` (`Graph` :45-121, `_stable_sort_perm`
:122-131, `build_graph` :140-397) for the layouts "bat" and "stream". The
JAX builder asks its TPU tuning table for tiles unless all are given, and
for a measured verdict on streaming; the port reads no table (ROADMAP
A.14): it takes every tile explicitly, and the cell census alone decides
whether a graph streams.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from geot_tpu_torch.graph.plan import (
    MAX_PREFETCH_TILES,
    BatPlan,
    build_bat_plan,
    packed_width,
)
from geot_tpu_torch.graph.stream_plan import (
    HybridPlan,
    StreamKnobs,
    build_stream_split_host,
    stream_plan_from_host,
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
    hyb / hyb_t: hybrid stream+gather plans (forward, transpose), both set
      or both None (None when the cell census rejects streaming in either
      direction); static weights are baked into them.
    build_stats: what `build_graph` decided and how long its host steps
      took (the reference keeps this in its module's LAST_BUILD_STATS):
      "stream" ({"forward", "transpose"}: each direction's census
      statistics and remainder edges) and "seconds" (per step). For
      logging only.
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
    hyb: Optional[HybridPlan] = None
    hyb_t: Optional[HybridPlan] = None
    build_stats: dict = dataclasses.field(default_factory=dict, compare=False)

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


def _build_hybrid(
    d_sorted: np.ndarray,
    g_idx: np.ndarray,
    w_e: Optional[np.ndarray],
    num_nodes: int,
    direction: str,
    build_stats: dict,
    *,
    feature_hint: int,
    bat_kw: dict,
    knobs: StreamKnobs,
    dev: torch.device,
) -> Optional[HybridPlan]:
    """The hybrid plan over dst-sorted edges (d_sorted, gather index g_idx,
    weights w_e), or None when the census rejects streaming. The
    remainder gets its own BAT plan (reference `structures.py:318-346`).
    Records the split's statistics and seconds under `direction` in
    `build_stats`."""
    t0 = time.perf_counter()
    families, rest_mask, stats = build_stream_split_host(
        d_sorted, g_idx, num_nodes, num_nodes, edge_weight=w_e,
        feature_hint=feature_hint, knobs=knobs,
    )
    build_stats["stream"][direction] = dict(stats, rest_edges=int(rest_mask.sum()))
    build_stats["seconds"][f"stream_split_{direction}"] = time.perf_counter() - t0
    if families is None:
        return None
    sp = tuple(stream_plan_from_host(a, m, device=dev) for a, m in families)
    rest = rest_src = rest_w = None
    t0 = time.perf_counter()
    if rest_mask.any():
        rest = build_bat_plan(d_sorted[rest_mask], num_nodes, device=dev, **bat_kw)
        rest_src = torch.from_numpy(g_idx[rest_mask].astype(np.int32)).to(dev)
        if w_e is not None:
            rest_w = torch.from_numpy(w_e[rest_mask].astype(np.float32)).to(dev)
    build_stats["seconds"][f"rest_bat_plan_{direction}"] = time.perf_counter() - t0
    return HybridPlan(sp, rest, rest_src, rest_w)


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
    stream_knobs: StreamKnobs = StreamKnobs(),
    device=None,
) -> Graph:
    """Host-side preprocessing: sort by dst, build the forward + transpose
    plans of `layouts`, move everything to `device` (default: the CUDA
    card).

    layouts: ("bat",), ("bat", "stream") or ("stream",). "bat" builds the
    BAT plans; "stream" builds the hybrid stream+gather plans `hyb` and
    `hyb_t` when the cell census (`stream_knobs`) accepts streaming in
    both directions. The slot layout ("slot") is not ported (ROADMAP A.9).
    The reference also consults its TPU tuning table for a measured
    verdict on streaming (one entry, `spmm_hyb:7:13:1`: feature 128,
    8-16 k edges, average degree 2-4, vetoes it); the port has no table,
    so on graphs of that bucket the two packages can differ.

    Tiles are explicit. The defaults bat_e_tile=1024, bat_s_tile=256 are
    the reference's TPU picks and are not measured on H100; the stream
    path's remainder takes the same BAT tiles. `e_tile` and `s_tile` size
    the slot layout, which is not ported; they are accepted so call sites
    match the reference. `max_chunk_bytes` caps one chunk's gathered
    [tiles*bat_e_tile, feature_hint] f32 block (the reference's
    GEOT_MAX_CHUNK_BYTES budget, `structures.py:257`), for the BAT plans
    and the remainder alike.
    """
    del e_tile, s_tile  # slot layout only (ROADMAP A.9)
    layouts = tuple(layouts)
    if layouts not in (("bat",), ("bat", "stream"), ("stream",)):
        raise NotImplementedError(
            f"layouts={layouts!r}: ('bat',), ('bat', 'stream') and ('stream',) "
            "are ported; the slot layout is ROADMAP A.9"
        )
    if feature_hint and packed_width(feature_hint):
        raise NotImplementedError(
            f"feature_hint={feature_hint} asks for packed narrow-feature plans, "
            "not ported yet (ROADMAP A.5 / B.3); use feature_hint >= 65"
        )
    dev = resolve_device(device)
    stats: dict = {"stream": {}, "seconds": {}}
    secs = stats["seconds"]
    t0 = time.perf_counter()
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
    w_t = None if edge_weight is None else edge_weight[perm_t]
    # chunk cap by gather bytes (reference structures.py:245-260)
    row_b = max(feature_hint if feature_hint else 128, 1) * 4
    mct = max(min(MAX_PREFETCH_TILES, max_chunk_bytes // (row_b * bat_e_tile)), 1)
    bat_kw = dict(e_tile=bat_e_tile, s_tile=bat_s_tile, max_chunk_tiles=mct)
    secs["sort"] = time.perf_counter() - t0
    bat = bat_t = None
    if "bat" in layouts:
        t0 = time.perf_counter()
        bat = build_bat_plan(dst, num_nodes, device=dev, **bat_kw)
        bat_t = build_bat_plan(src_t, num_nodes, device=dev, **bat_kw)
        secs["bat_plans"] = time.perf_counter() - t0
    hyb = hyb_t = None
    if "stream" in layouts and len(src):
        kw = dict(feature_hint=feature_hint, bat_kw=bat_kw, knobs=stream_knobs, dev=dev)
        hyb = _build_hybrid(dst, src, edge_weight, num_nodes, "forward", stats, **kw)
        if hyb is not None:
            hyb_t = _build_hybrid(src_t, dst[perm_t], w_t, num_nodes, "transpose", stats,
                                  **kw)
            if hyb_t is None:
                # the forward streams but the transpose does not: autograd
                # needs the pair, so both stay on the gather path
                hyb = None

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
        edge_weight_t=None if w_t is None else t(w_t),
        num_nodes=int(num_nodes),
        hyb=hyb,
        hyb_t=hyb_t,
        build_stats=stats,
    )
