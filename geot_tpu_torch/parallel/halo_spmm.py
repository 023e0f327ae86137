"""SpMM over several processes: a padded all-to-all halo exchange and each
part's local segment reduce.

Port of `geot_tpu/parallel/halo_spmm.py` (`node_sharding` :37,
`_block_index` :42, `block_nodes` :53, `unblock_nodes` :64, `pad_nodes`
:75, `_local_reduce` :101, `_stream_reduce` :119, `halo_spmm` :137-254).
The reference is one `shard_map` program over a mesh axis with
`lax.all_to_all` and a `custom_vjp`; the port runs one process per part in
a `torch.distributed` group, with `all_to_all_single` and a
`torch.autograd.Function`. One aggregation out[d] = sum_e w_e * x[s_e]
over a graph cut by `partition_graph`:

  1. each rank gathers the rows its peers need from its local block and
     starts one asynchronous `all_to_all_single` of the padded halo slots;
  2. while the exchange is in flight it reduces its interior edges, which
     read only the local block; then it waits and reduces its boundary
     edges from the receive buffer. Its output rows are final.

The backward mirrors it: the boundary gradient is reduced by receive
position over the transposed plans, sent back by a second all-to-all
(the interior gradient is reduced between its start and its wait), and
added into the local gradient at the sent rows, peer by peer in peer order
(a row sent to several peers gets each peer's part in that fixed order; no
atomics over repeated rows). Every rank takes part in every exchange, a
rank whose part has no edges too. The exchange is whatever the group's
backend does with the tensors it is given: the port copies nothing to the
host itself.

The reduces are the port's kernels: the slot layout's
`plan_segment_sum_sr` / `_sr_packed` (the edge-row kernel reading
x[src[e]] itself), the BAT layout's `bat_segment_sum` (the same kernel,
each part's plan whole), and the hybrid layout's `stream_segment_acc`
adding the streamed interior cells into the interior BAT sum.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from geot_tpu_torch.ops.api import BACKENDS, _slot_spmm
from geot_tpu_torch.ops.reference import plan_segment_sum_sr_plain
from geot_tpu_torch.parallel.bat_partition import PartBat, part_bat_reduce
from geot_tpu_torch.parallel.partition import PartitionedGraph, PartView, SlotPart
from geot_tpu_torch.parallel.stream_partition import part_stream_reduce

__all__ = ["halo_spmm", "node_sharding", "block_nodes", "unblock_nodes", "pad_nodes",
           "part_slot_reduce"]


def node_sharding(pg: PartitionedGraph, rank: int) -> slice:
    """The rows of the blocked [P * nodes_per_part, ...] layout that rank
    `rank` holds: the port's counterpart of the reference's sharding spec
    (rows split over the parts)."""
    if not 0 <= rank < pg.num_parts:
        raise ValueError(f"rank {rank} outside [0, {pg.num_parts})")
    npp = pg.nodes_per_part
    return slice(rank * npp, (rank + 1) * npp)


def _block_index(pg: PartitionedGraph):
    """(gather index [P*npp], valid [P*npp]) numpy: the global node of each
    blocked row, for the edge-balanced ranges of unequal width."""
    starts = np.asarray(pg.part_start[:-1], np.int64)
    ends = np.asarray(pg.part_start[1:], np.int64)
    npp = pg.nodes_per_part
    idx = (starts[:, None] + np.arange(npp)[None, :]).reshape(-1)
    valid = idx < np.repeat(ends, npp)
    return np.minimum(idx, pg.num_nodes - 1), valid


def block_nodes(x: torch.Tensor, pg: PartitionedGraph) -> torch.Tensor:
    """[num_nodes, ...] -> the blocked [P*nodes_per_part, ...] layout: part
    p's rows at [p*npp, p*npp + width_p), zeros past them. The parts'
    widths differ (edge-balanced ranges), so this is a gather."""
    idx, valid = _block_index(pg)
    out = x[torch.from_numpy(idx).to(x.device)]
    v = torch.from_numpy(valid).to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(v, out, torch.zeros((), dtype=out.dtype, device=out.device))


def unblock_nodes(xb: torch.Tensor, pg: PartitionedGraph) -> torch.Tensor:
    """The inverse of `block_nodes`: blocked [P*npp, ...] -> [num_nodes, ...]."""
    starts = np.asarray(pg.part_start[:-1], np.int64)
    g = np.arange(pg.num_nodes)
    owner = np.searchsorted(np.asarray(pg.part_start), g, side="right") - 1
    pos = owner * pg.nodes_per_part + (g - starts[owner])
    return xb[torch.from_numpy(pos).to(xb.device)]


def pad_nodes(x: torch.Tensor, pg: PartitionedGraph) -> torch.Tensor:
    """`block_nodes` (the reference keeps the name for earlier callers)."""
    return block_nodes(x, pg)


def part_slot_reduce(fam: SlotPart, xr: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """One part's slot-plan segment sum of w_slot * xr[src] into
    [num_segments, F] float32.

    "auto": `_slot_spmm`, the segment_spmm slot route (the reference's
    `_pick_mode` / `_plan_sum_one`): `plan_segment_sum_sr_packed` at F <=
    64, else `plan_segment_sum_sr`, each reading xr[src[e]] in the kernel
    over the whole plan on CUDA, their plain versions on the CPU.
    "reference": `plan_segment_sum_sr_plain`, the reference's
    `use_pallas=False` route."""
    plan = fam.plan
    if backend == "reference":
        return plan_segment_sum_sr_plain(plan, xr.float(), fam.w, src=fam.src)[
            : plan.num_segments]
    return _slot_spmm(plan, xr, fam.w, fam.src)


def _reduce(fam, xr: torch.Tensor, backend: str) -> torch.Tensor:
    if isinstance(fam, PartBat):
        return part_bat_reduce(fam, xr, backend)
    return part_slot_reduce(fam, xr, backend)


def _interior_reduce(view: PartView, x: torch.Tensor, backend: str,
                     transpose: bool = False) -> torch.Tensor:
    """The part's interior sum (or, with `transpose`, its interior
    gradient) from the local block alone: no dependence on the exchange.
    In the hybrid layout the streamed cells are added into the interior
    BAT residue's sum (`stream_segment_acc`)."""
    fam = view.interior_t if transpose else view.interior
    sp = view.stream_t if transpose else view.stream
    if sp is None:
        return _reduce(fam, x, backend)
    carry = part_bat_reduce(fam, x, backend, all_rows=True)
    return part_stream_reduce(sp, x, backend, carry=carry)[: view.nodes_per_part]


def _boundary_reduce(view: PartView, recv: torch.Tensor, backend: str) -> torch.Tensor:
    """The part's boundary sum from the receive buffer [P*H, F]."""
    return _reduce(view.boundary, recv, backend)


def _boundary_reduce_t(view: PartView, g: torch.Tensor, backend: str) -> torch.Tensor:
    """The boundary gradient by receive position, [P*H, F]."""
    return _reduce(view.boundary_t, g, backend)


def _exchange(send: torch.Tensor, group):
    """Start the all-to-all of [P*H, F] halo slots: chunk q goes to rank q,
    chunk q of the result comes from rank q. Returns (result, work)."""
    recv = torch.empty_like(send)
    work = dist.all_to_all_single(recv, send, group=group, async_op=True)
    return recv, work


def _send_back(g_int: torch.Tensor, view: PartView, back: torch.Tensor) -> torch.Tensor:
    """Add the peers' returned gradients into the local gradient at the rows
    sent to them, peer by peer in peer order (each peer's rows unique)."""
    for rows, pos in view.send_back:
        g_int.index_add_(0, rows, back.index_select(0, pos))
    return g_int


class _HaloSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, view, group, backend):
        ctx.view, ctx.group, ctx.backend = view, group, backend
        send = (x.index_select(0, view.send_gather) * view.send_mask.to(x.dtype)).contiguous()
        recv, work = _exchange(send, group)
        out = _interior_reduce(view, x, backend)
        work.wait()
        out = out + _boundary_reduce(view, recv, backend)
        return out.to(x.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        view, backend = ctx.view, ctx.backend
        g = g.contiguous()
        h = _boundary_reduce_t(view, g, backend).to(g.dtype).contiguous()
        back, work = _exchange(h, ctx.group)
        g_int = _interior_reduce(view, g, backend, transpose=True)
        work.wait()
        return _send_back(g_int, view, back.float()).to(g.dtype), None, None, None


def halo_spmm(x_local: torch.Tensor, part: PartView, group=None, *,
              backend: str = "auto") -> torch.Tensor:
    """The distributed weighted SpMM on this rank: x_local is the rank's
    [nodes_per_part, F] block of the blocked layout, `part` its view
    (`PartitionedGraph.part(rank, device)`), `group` a process group of
    num_parts ranks (None: the default group). Returns the rank's block of
    the aggregated features, in x's dtype (the sums in float32).
    Differentiable in x (the edge weights are baked into the partition).

    Raises when the group's size is not the partition's part count, when
    the rank is not the view's, or when x is not the view's block on its
    device. backend: "auto" (the kernels on CUDA, their plain versions on
    the CPU) or "reference" (the plain scatters)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: expected one of {BACKENDS}")
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if size != part.num_parts:
        raise ValueError(f"the group has {size} ranks, the partition {part.num_parts} parts")
    if rank != part.rank:
        raise ValueError(f"rank {rank} was given part {part.rank}'s view")
    if x_local.dim() != 2 or x_local.shape[0] != part.nodes_per_part:
        raise ValueError(f"x_local must be [{part.nodes_per_part}, F], got "
                         f"{tuple(x_local.shape)}")
    if x_local.device != part.device:
        raise ValueError(f"x_local is on {x_local.device}, the view on {part.device}")
    return _HaloSpmm.apply(x_local, part, group, backend)
