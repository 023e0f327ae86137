"""geot_tpu_torch — the PyTorch/CUDA port of geot_tpu for one NVIDIA H100.

The JAX package `geot_tpu` stays the reference; this package imports
nothing of it (nor JAX) and keeps its own copies of what it needs. It
covers GCN, GIN, GraphSAGE, GAT, SGC and APPNP inference and training
over slot-layout plans, block-aligned-tile (BAT) plans, packed BAT plans
for narrow features and hybrid stream+gather plans:

    prepare_graph -> GCN -> GCNConv -> segment_spmm -> _spmm_fwd_bat
      -> _bat_row_sum -> bat_segment_sum (hand-written CUDA, sm_90a: the
         edge-row kernel, reading x[src[e]] itself)
    prefer="sr": GCN / GraphSAGE -> segment_spmm -> _slot_spmm
      -> plan_segment_sum_sr / _sr_packed (CUDA, sm_90a: the edge-row
         kernel, reading x[src[e]] itself); the mean's degree
         -> segment_counts -> plan_segment_sum_pr (CUDA, sm_90a: the
         transposed sum over the same row schedule)
    per-call weights, prefer_dyn="sr": GCN -> segment_spmm -> _spmm_fwd_slot_dyn
      -> plan_segment_sum_sr2 / _packed2 (CUDA, sm_90a: the edge-row kernel)
    GAT -> GATConv -> gat_attention_spmm -> mh_spmm -> plan_segment_sum_mh
      (CUDA, sm_90a: the edge-row kernel with per-head weights)
    feature_hint <= 64: GIN / APPNP / SGC -> segment_spmm -> _spmm_fwd_bat
      -> _bat_row_sum -> bat_segment_sum_packed (CUDA, sm_90a) at 8-64 columns
    layouts=("bat", "stream"): segment_spmm -> _spmm_fwd_hybrid
      -> stream_segment_sum / stream_segment_acc (CUDA, sm_90a) per stream
         family + the BAT path over the remainder
    bucket_table_bytes=...: segment_spmm -> _spmm_fwd_bucketed
      -> bucketed_sum (CUDA, sm_90a: the edge-row kernel over the bucketed
         plan's row schedule)

    pattern_transform(fn, graph) (`compiler`): a plain PyTorch function's
      x[src] * w[:, None] -> index_add_ / scatter_add_ rewritten to
      gather_weight_scatter -> bat_segment_sum (or plan_segment_sum_sr2 /
      _packed2 on a slot_dyn graph; sddmm_bat for dw), the unweighted form
      to gather_scatter (BAT, stream or slot kernels), the 3-D multi-head
      form to mh_spmm -> plan_segment_sum_mh

The backward of every fused SpMM runs the same kernels over the transpose
plans; the gradient of per-call edge weights runs `sddmm_bat` (CUDA, sm_90a:
a per-edge dot reading both rows itself) over BAT plans and the same
kernel as `edge_dots` over slot plans, per head for GAT's attention.
`models.train` holds the trainer and the checkpoints shared with the JAX
package; `graph.cache` saves and loads built graphs with their schedules.
`build_graph` (and `prepare_graph`) take the tiles, the layout
preferences and the slot mode hint they are not given from the port's
tuning table (`tuning`, shipped empty: the defaults hold until an H100
sweep fills it), and a measured verdict on streaming from it; `native`
is the C++ host runtime the plan builders use where g++ is there.

Entry points run on the card (`device="cuda"`) unless the caller asks for
the CPU, where every kernel wrapper runs its plain PyTorch version.
"""

from geot_tpu_torch.utils.device import resolve_device
from geot_tpu_torch.graph import (
    Graph,
    SegmentPlan,
    add_self_loops,
    build_graph,
    build_segment_plan,
    coo_to_csr,
    csr_to_coo,
    gcn_norm,
    sort_edges_by_dst,
)
from geot_tpu_torch.ops import (
    csr_gws,
    dispatch_path,
    gather_scatter,
    gather_weight_scatter,
    index_scatter,
    mh_spmm,
    mh_spmm_transposed,
    sddmm_coo,
    segment_spmm,
)
from geot_tpu_torch.models import (
    APPNP,
    GAT,
    GCN,
    GIN,
    SGC,
    GATConv,
    GCNConv,
    GINConv,
    GraphSAGE,
    SAGEConv,
    prepare_graph,
)

__version__ = "0.1.0"

__all__ = [
    "resolve_device",
    "index_scatter",
    "gather_scatter",
    "gather_weight_scatter",
    "csr_gws",
    "mh_spmm",
    "mh_spmm_transposed",
    "sddmm_coo",
    "segment_spmm",
    "dispatch_path",
    "Graph",
    "SegmentPlan",
    "build_graph",
    "build_segment_plan",
    "coo_to_csr",
    "csr_to_coo",
    "sort_edges_by_dst",
    "add_self_loops",
    "gcn_norm",
    "GCN",
    "GCNConv",
    "GraphSAGE",
    "SAGEConv",
    "GAT",
    "GATConv",
    "GIN",
    "GINConv",
    "SGC",
    "APPNP",
    "prepare_graph",
]
