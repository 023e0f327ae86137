"""Graph container with prebuilt slot, BAT and hybrid stream+gather plans.

Port of `geot_tpu/graph/structures.py` (`Graph` :45-121, `_stable_sort_perm`
:122-131, `_slot_weights_host` :115-119, `build_graph` :140-397, with
`edge_pos_t` :233-236 and the bucketed BAT plans `bat_b` / `bat_b_t`
:79-82, :263-290) for the layouts "slot", "bat" and "stream". As the JAX
`build_graph` does, the port's asks its tuning table
(`geot_tpu_torch.tuning`) for the tiles, the slot plans' mode hint and the
layout preferences it is not given, and for a measured verdict on
streaming. The port's table is its own and ships empty, so by default the
knobs are `DEFAULT_KNOBS` and the cell census alone decides whether a
graph streams.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from geot_tpu_torch import native
from geot_tpu_torch.graph.plan import (
    MAX_PREFETCH_TILES,
    BatPlan,
    BucketedBatPlan,
    SegmentPlan,
    build_bat_plan,
    build_bucketed_bat_plan,
    build_segment_plan_host,
    packed_width,
    plan_from_host,
)
from geot_tpu_torch.graph.stream_plan import (
    HybridPlan,
    StreamKnobs,
    build_stream_split_host,
    stream_plan_from_host,
)
from geot_tpu_torch.tuning.heuristics import (
    DEFAULT_KNOBS,
    bucket_key,
    load_table,
    select_config_ex,
)
from geot_tpu_torch.utils.device import resolve_device
from geot_tpu_torch.utils.trace import count

__all__ = ["Graph", "build_graph", "count_stream_split"]


# layout preferences `build_graph` takes for the fused SpMM: BAT, the slot
# plans, or the plain route ("xla", the reference's name)
PREFERENCES = ("bat", "sr", "xla")
# the preference of each table mode: 'bat_packed' routes as 'bat' (a narrow
# `feature_hint` packs the BAT plans), 'packed' and 'pr' as 'sr' (the slot
# plans' kernels choose by width), 'hybrid' as 'bat' (the hybrid plans,
# where the census builds them, come first whatever the preference)
_PREFERENCE_OF_MODE = {"bat": "bat", "bat_packed": "bat", "hybrid": "bat", "sr": "sr",
                       "packed": "sr", "pr": "sr", "xla": "xla"}
LAYOUTS = (("bat",), ("bat", "stream"), ("stream",), ("slot",), ("bat", "slot"),
           ("bat", "slot", "stream"))


@dataclasses.dataclass(frozen=True)
class Graph:
    """dst-sorted COO adjacency + plans (torch tensors on one device).

    src, dst: [nnz] int32, sorted by dst ascending.
    edge_weight: [nnz] float32 or None — static per-edge weights.
    bat / bat_t: forward plan (reduce over dst) and transpose plan (reduce
      over src, edges sorted by src; drives the backward of every fused
      SpMM).
    perm_t: [nnz] int32 — dst-sorted position of the e-th src-sorted edge.
    dst_t, edge_weight_t: dst[perm_t], edge_weight[perm_t].
    dst_ptr, src_ptr: [num_nodes + 1] int32 — the run boundaries of dst
      (row i's edges are dst_ptr[i] .. dst_ptr[i + 1] - 1) and of
      src[perm_t] (the src-sorted order). The edge softmax walks both.
    hyb / hyb_t: hybrid stream+gather plans (forward, transpose), both set
      or both None (None when the cell census rejects streaming in either
      direction); static weights are baked into them.
    plan / plan_t: slot-layout plans (forward over dst, transpose over
      src), or None without the "slot" layout.
    w_slots / w_slots_t: [T, e_tile] static weights in slot order (pads
      0) for plan / plan_t, or None.
    edge_pos_t: [T_t, e_tile] int32, the dst-sorted edge of each slot of
      plan_t (perm_t[plan_t.edge_pos]; pads hold perm_t[0]), so per-call
      weights reach plan_t's slots in one gather; None without the "slot"
      layout.
    bat_b / bat_b_t: bucketed BAT plans (forward, transpose; the graph's
      static weights baked in), both set or both None; the fused SpMM's
      route for the graph's own or no weights where they exist.
    prefer / prefer_dyn: layout preference for graph-weight or unweighted
      SpMM / per-call weights: "bat" or "sr" (the slot layout).
    build_stats: what `build_graph` decided and how long its host steps
      took (the reference keeps this in its module's LAST_BUILD_STATS):
      "stream" ({"forward", "transpose"}: each direction's census
      statistics and remainder edges), "seconds" (per step) and
      "row_schedule" (per plan with an edge-row schedule, the hybrid
      remainders' and the bucketed plans' too: its host seconds, inside
      the plan's step, and its bytes). For logging only.
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
    plan: Optional[SegmentPlan] = None
    plan_t: Optional[SegmentPlan] = None
    w_slots: Optional[torch.Tensor] = None
    w_slots_t: Optional[torch.Tensor] = None
    edge_pos_t: Optional[torch.Tensor] = None
    bat_b: Optional[BucketedBatPlan] = None
    bat_b_t: Optional[BucketedBatPlan] = None
    prefer: str = "bat"
    prefer_dyn: str = "bat"
    build_stats: dict = dataclasses.field(default_factory=dict, compare=False)
    dst_ptr: Optional[torch.Tensor] = None
    src_ptr: Optional[torch.Tensor] = None

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device


def _stable_sort_perm(key: np.ndarray, num_keys: int) -> np.ndarray:
    """Stable sort permutation of `key` in [0, num_keys): the native
    runtime's counting sort where it is built, else numpy's argsort (a
    stable permutation is unique, so both give the same array)."""
    perm = native.sort_by_key(np.asarray(key, np.int32), int(num_keys))
    if perm is not None:
        return perm
    return np.argsort(np.asarray(key), kind="stable")


def _run_ptr(key: np.ndarray, num_keys: int) -> np.ndarray:
    """The [num_keys + 1] int32 run boundaries of a sorted key array."""
    ptr = np.zeros(num_keys + 1, dtype=np.int64)
    np.cumsum(np.bincount(key, minlength=num_keys)[:num_keys], out=ptr[1:])
    return ptr.astype(np.int32)


def _table_knobs(feature_hint: int, nnz: int, num_nodes: int) -> Tuple[dict, bool]:
    """The tuning table's answers for `build_graph`'s knobs, as the
    reference takes them (`geot_tpu/graph/structures.py:150-175`): the
    "spmm" and "spmm_dyn" picks give `prefer` / `prefer_dyn`, the first
    slot pick the slot tiles and `mode_hint`, the first BAT pick the BAT
    tiles. Only measured picks count (source "table" or "near"): an empty
    table answers nothing. Returns (knobs, unpack): unpack where the
    measured pick of the graph's SpMM (else of per-call weights, where the
    first is the plain route) is the unpacked "bat" or "sr"."""
    out, picks = {}, []
    for op, knob in (("spmm", "prefer"), ("spmm_dyn", "prefer_dyn")):
        cfg, source = select_config_ex(feature_hint, nnz, num_nodes, op=op)
        if source != "default":
            out[knob] = _PREFERENCE_OF_MODE[cfg.mode]
            picks.append(cfg)
    slot = [cfg for cfg in picks if cfg.mode in ("sr", "packed")]
    bat = [cfg for cfg in picks if cfg.mode.startswith("bat")]
    if slot:
        out.update(e_tile=slot[0].e_tile, s_tile=slot[0].s_tile, mode_hint=slot[0].mode)
    if bat:
        out.update(bat_e_tile=bat[0].e_tile, bat_s_tile=bat[0].s_tile)
    modes = [cfg.mode for cfg in picks if cfg.mode != "xla"]
    return out, bool(modes) and modes[0] in ("bat", "sr")


def _slot_weights_host(arrays: dict, w: np.ndarray) -> np.ndarray:
    """Static edge weights in slot order, pads 0."""
    ep = arrays["edge_pos"].reshape(-1)
    ws = w[np.minimum(ep, len(w) - 1)].reshape(arrays["mask"].shape)
    return (ws * arrays["mask"]).astype(np.float32)


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
    t0 = time.perf_counter()  # the families' kernel schedules, and the copy to dev
    sp = tuple(stream_plan_from_host(a, m, device=dev) for a, m in families)
    build_stats["seconds"][f"stream_plans_{direction}"] = time.perf_counter() - t0
    rest = rest_src = rest_w = None
    t0 = time.perf_counter()
    if rest_mask.any():
        rest = build_bat_plan(d_sorted[rest_mask], num_nodes, device=dev, **bat_kw)
        rest_src = torch.from_numpy(g_idx[rest_mask].astype(np.int32)).to(dev)
        if w_e is not None:
            rest_w = torch.from_numpy(w_e[rest_mask].astype(np.float32)).to(dev)
    build_stats["seconds"][f"rest_bat_plan_{direction}"] = time.perf_counter() - t0
    return HybridPlan(sp, rest, rest_src, rest_w)


def count_stream_split(hyb: Optional[HybridPlan], hyb_t: Optional[HybridPlan]) -> None:
    """Adds each direction's streamed and total edges of a graph's hybrid
    plans to the process's counter record (`utils.trace.count`), under
    `stream.<forward|transpose>.streamed_edges` and `.edges`. Nothing for
    a graph without hybrid plans."""
    for direction, h in (("forward", hyb), ("transpose", hyb_t)):
        if h is None:
            continue
        streamed = sum(int(sp.num_edges) for sp in h.stream)
        rest = 0 if h.rest_src is None else int(h.rest_src.numel())
        count(f"stream.{direction}.streamed_edges", streamed)
        count(f"stream.{direction}.edges", streamed + rest)


def build_graph(
    src,
    dst,
    num_nodes: int,
    edge_weight=None,
    *,
    e_tile: Optional[int] = None,
    s_tile: Optional[int] = None,
    bat_e_tile: Optional[int] = None,
    bat_s_tile: Optional[int] = None,
    feature_hint: int = 128,
    assume_sorted: bool = False,
    layouts: Tuple[str, ...] = ("bat", "slot", "stream"),
    max_chunk_bytes: int = 1 << 30,
    stream_knobs: StreamKnobs = StreamKnobs(),
    prefer: Optional[str] = None,
    prefer_dyn: Optional[str] = None,
    mode_hint: Optional[str] = None,
    max_chunk_slots: int = 4 << 20,
    bucket_table_bytes: Optional[int] = None,
    bucket_rows: int = 128 * 1024,
    device=None,
) -> Graph:
    """Host-side preprocessing: sort by dst, build the forward + transpose
    plans of `layouts`, move everything to `device` (default: the CUDA
    card).

    layouts: one of LAYOUTS (default the reference's, all three). "slot"
    builds the slot-layout plans `plan`
    and `plan_t` (e_tile x s_tile; pack-aligned to 16 edges when
    `feature_hint` <= 64), with the static weights in slot order; "bat"
    builds the BAT plans (bat_e_tile x bat_s_tile); "stream" builds the
    hybrid stream+gather plans `hyb` and `hyb_t` when the cell census
    (`stream_knobs`) accepts streaming in both directions and
    `feature_hint` > 64. A measured verdict in the tuning table
    (`spmm_hyb:<bucket>`, where the sweep timed the hybrid route on the
    graph's bucket) vetoes streaming, or endorses it with the census's
    margin waived; `build_stats["stream_decided_by"]` says which decided
    ("census", "table_veto", "table_endorse").

    The tiles, `prefer` / `prefer_dyn` (one of PREFERENCES: which route the
    fused SpMM takes for graph or no weights / per-call weights; a slot
    preference degrades to "bat" without a slot plan, "xla" takes the
    plain route) and the slot plans' `mode_hint` ("auto", "sr", "pr"; a
    table's "packed" is kept as the reference keeps it) come from the
    caller, else from the tuning table's measured "spmm" / "spmm_dyn"
    picks for (feature_hint, edges, nodes) (`_table_knobs`), else from
    `DEFAULT_KNOBS`: 512 x 256 slot tiles, 1024 x 256 BAT tiles, "bat",
    "bat", "auto" — the reference's answer when all tiles are given, TPU
    picks not measured on the H100. The shipped table is empty, so the
    defaults hold until an H100 sweep fills it. `max_chunk_slots` caps a
    slot plan's chunk; `max_chunk_bytes` caps one chunk's gathered
    [tiles*bat_e_tile, feature_hint] f32 block (the reference's
    GEOT_MAX_CHUNK_BYTES budget, `structures.py:257`), for the BAT plans
    and the stream remainder alike.

    With `feature_hint` <= 64 the BAT plans are packed for the narrow
    kernel (`bat_segment_sum_packed`): km_pack = 128 //
    packed_width(feature_hint) (2 at 33-64 features, 16 at 1-8), kept where
    it divides `bat_e_tile`, and `dst_km` in each plan (reference
    `structures.py:198-209`). The reference then also takes `bat_e_tile`
    = `e_tile` (512) unless a tile is given (`structures.py:252-254`), a
    TPU pick not measured on the H100; here the default stays 1024. A
    measured table winner "bat" or "sr" builds unpacked plans at any width
    (the reference's `table_picked`, `structures.py:200-208`). The stream
    remainder's BAT plan stays unpacked: the hybrid path is built only
    past 64 features, as in the reference.

    With "bat" in layouts, `feature_hint` > 64 and a node table of
    num_nodes * feature_hint * 4 bytes past `bucket_table_bytes`, the
    bucketed BAT plans `bat_b` and `bat_b_t` are built too (sources in
    buckets of `bucket_rows` rows; the reference's gate, whose threshold
    comes from GEOT_BUCKET_TABLE_BYTES and defaults to 2**62, that is off).
    None, the default, builds none. `bucket_rows` (128 Ki rows) is the
    reference's TPU pick for its row-sliced gather, not measured on the
    H100: the card's sum reads x[src[e]] by global ids and needs no
    slicing, so the buckets only order each row's terms.

    Every slot plan and every BAT plan (the hybrid remainder's too)
    carries the edge-row kernel's schedule (`plan.row_sched`, made from the
    plan's own host arrays); `build_stats["row_schedule"]` holds each
    one's host seconds and bytes on the device, under "plan", "plan_t",
    "bat", "bat_t", "bat_b", "bat_b_t", "hyb.rest" and "hyb_t.rest".
    """
    layouts = tuple(layouts)
    if layouts not in LAYOUTS:
        raise NotImplementedError(f"layouts={layouts!r}: one of {LAYOUTS}")
    dev = resolve_device(device)
    stats: dict = {"stream": {}, "seconds": {}}
    secs = stats["seconds"]
    t0 = time.perf_counter()
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    knobs = dict(e_tile=e_tile, s_tile=s_tile, bat_e_tile=bat_e_tile, bat_s_tile=bat_s_tile,
                 prefer=prefer, prefer_dyn=prefer_dyn, mode_hint=mode_hint)
    tuned, unpack = {}, False
    if None in knobs.values():
        tuned, unpack = _table_knobs(feature_hint, len(src), num_nodes)
    e_tile, s_tile, bat_e_tile, bat_s_tile, prefer, prefer_dyn, mode_hint = (
        v if v is not None else tuned.get(k, DEFAULT_KNOBS[k]) for k, v in knobs.items())
    for name, p in (("prefer", prefer), ("prefer_dyn", prefer_dyn)):
        if p not in PREFERENCES:
            raise ValueError(f"{name}={p!r}: one of {PREFERENCES}")
    nw = packed_width(feature_hint) if feature_hint else 0
    # a measured "bat" or "sr" winner is an unpacked layout: its BAT plans
    # stay unpacked at any width (the reference's `table_picked`)
    km_pack = 128 // nw if nw and not unpack else 0
    if edge_weight is not None:
        edge_weight = np.asarray(edge_weight, dtype=np.float32)
    if not assume_sorted:
        order = _stable_sort_perm(dst, num_nodes)
        src, dst = src[order], dst[order]
        if edge_weight is not None:
            edge_weight = edge_weight[order]
    perm_t = _stable_sort_perm(src, num_nodes)
    src_t = src[perm_t]
    w_t = None if edge_weight is None else edge_weight[perm_t]
    # chunk cap by gather bytes (reference structures.py:245-260)
    row_b = max(feature_hint if feature_hint else 128, 1) * 4
    mct = max(min(MAX_PREFETCH_TILES, max_chunk_bytes // (row_b * bat_e_tile)), 1)
    bat_kw = dict(e_tile=bat_e_tile, s_tile=bat_s_tile, max_chunk_tiles=mct)
    secs["sort"] = time.perf_counter() - t0

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    plan = plan_t = w_slots = w_slots_t = edge_pos_t = None
    if "slot" in layouts:
        t0 = time.perf_counter()
        kw = dict(e_tile=e_tile, s_tile=s_tile, num_src_nodes=num_nodes,
                  mode_hint=mode_hint, pack_align=16 if nw else 1,
                  max_chunk_slots=max_chunk_slots)
        arrs, meta = build_segment_plan_host(dst, src, num_nodes, **kw)
        arrs_t, meta_t = build_segment_plan_host(src_t, dst[perm_t], num_nodes, **kw)
        if edge_weight is not None and len(edge_weight):
            w_slots = t(_slot_weights_host(arrs, edge_weight))
            w_slots_t = t(_slot_weights_host(arrs_t, w_t))
        ep_t = arrs_t["edge_pos"]
        if len(src):
            ep_t = perm_t.astype(np.int64)[ep_t.reshape(-1)].reshape(ep_t.shape)
        edge_pos_t = t(ep_t.astype(np.int32))
        plan = plan_from_host(arrs, meta, device=dev)
        plan_t = plan_from_host(arrs_t, meta_t, device=dev)
        secs["slot_plans"] = time.perf_counter() - t0
    bat = bat_t = None
    if "bat" in layouts:
        t0 = time.perf_counter()
        bat = build_bat_plan(dst, num_nodes, device=dev, km_pack=km_pack, **bat_kw)
        bat_t = build_bat_plan(src_t, num_nodes, device=dev, km_pack=km_pack, **bat_kw)
        secs["bat_plans"] = time.perf_counter() - t0
    bat_b = bat_b_t = None
    table_bytes = num_nodes * max(feature_hint or 0, 1) * 4
    if ("bat" in layouts and nw == 0 and bucket_table_bytes is not None
            and table_bytes > bucket_table_bytes):
        t0 = time.perf_counter()
        kw = dict(bat_kw, bucket_rows=bucket_rows, device=dev)
        bat_b = build_bucketed_bat_plan(src, dst, num_nodes, num_nodes, edge_weight=edge_weight,
                                        **kw)
        bat_b_t = build_bucketed_bat_plan(dst[perm_t], src_t, num_nodes, num_nodes,
                                          edge_weight=w_t, **kw)
        secs["bucketed_plans"] = time.perf_counter() - t0
    hyb = hyb_t = None
    if "stream" in layouts and nw == 0 and len(src):
        # a measured verdict on this bucket ('spmm_hyb:<bucket>', written by
        # the sweep where it timed the hybrid route) vetoes the census, or
        # endorses it without the census's margin; else the census decides
        verdict = load_table().get(f"spmm_hyb:{bucket_key(feature_hint, len(src), num_nodes)}")
        decided = ("census" if verdict is None else
                   "table_endorse" if verdict.mode == "hybrid" else "table_veto")
        stats["stream_decided_by"] = decided
        if decided != "table_veto":
            if decided == "table_endorse":
                stream_knobs = dataclasses.replace(stream_knobs, margin=1.0)
            kw = dict(feature_hint=feature_hint, bat_kw=bat_kw, knobs=stream_knobs, dev=dev)
            hyb = _build_hybrid(dst, src, edge_weight, num_nodes, "forward", stats, **kw)
            if hyb is not None:
                hyb_t = _build_hybrid(src_t, dst[perm_t], w_t, num_nodes, "transpose", stats,
                                      **kw)
                if hyb_t is None:
                    # the forward streams but the transpose does not: autograd
                    # needs the pair, so both stay on the gather path
                    hyb = None
            count_stream_split(hyb, hyb_t)

    rests = [(f"{name}.rest", h.rest) for name, h in (("hyb", hyb), ("hyb_t", hyb_t))
             if h is not None]
    stats["row_schedule"] = {
        name: {"seconds": p.row_sched.seconds, "bytes": p.row_sched.nbytes}
        for name, p in [("plan", plan), ("plan_t", plan_t), ("bat", bat), ("bat_t", bat_t),
                        ("bat_b", bat_b), ("bat_b_t", bat_b_t)]
        + rests if p is not None and p.row_sched is not None}
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
        plan=plan,
        plan_t=plan_t,
        w_slots=w_slots,
        w_slots_t=w_slots_t,
        edge_pos_t=edge_pos_t,
        bat_b=bat_b,
        bat_b_t=bat_b_t,
        # slot preferences degrade to "bat" when no slot plan was built
        prefer=prefer if plan is not None or prefer != "sr" else "bat",
        prefer_dyn=prefer_dyn if plan is not None or prefer_dyn != "sr" else "bat",
        build_stats=stats,
        dst_ptr=t(_run_ptr(dst, num_nodes)),
        src_ptr=t(_run_ptr(src_t, num_nodes)),
    )
