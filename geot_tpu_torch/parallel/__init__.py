"""Execution over several processes: the port of `geot_tpu.parallel`.

`partition_graph` cuts a graph into dst-contiguous, edge-balanced parts
with a halo exchange schedule; `PartitionedGraph.part(rank, device)` gives
one rank its plans; `halo_spmm` runs the SpMM over a `torch.distributed`
group (one process per part), and `dist_train` trains a GCN over it.
`launch.spawn_ranks` starts the ranks on one machine.
"""

from geot_tpu_torch.parallel.partition import (
    PartitionedGraph,
    PartView,
    SlotPart,
    partition_graph,
)
from geot_tpu_torch.parallel.halo_spmm import (
    block_nodes,
    halo_spmm,
    node_sharding,
    pad_nodes,
    unblock_nodes,
)
from geot_tpu_torch.parallel.dist_train import (
    gcn_forward,
    init_gcn_params,
    make_dist_train_step,
    params_from_jax,
    shard_inputs,
)
from geot_tpu_torch.parallel.launch import spawn_ranks

__all__ = [
    "PartitionedGraph",
    "PartView",
    "SlotPart",
    "partition_graph",
    "halo_spmm",
    "node_sharding",
    "block_nodes",
    "unblock_nodes",
    "pad_nodes",
    "init_gcn_params",
    "params_from_jax",
    "gcn_forward",
    "make_dist_train_step",
    "shard_inputs",
    "spawn_ranks",
]
