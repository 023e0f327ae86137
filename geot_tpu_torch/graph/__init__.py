from geot_tpu_torch.graph.datasets import (
    DATASET_SHAPES,
    GraphData,
    synthetic_clustered_graph,
    synthetic_graph,
)
from geot_tpu_torch.graph.plan import (
    BatPlan,
    build_bat_plan,
    build_bat_plan_host,
    compute_chunks,
)
from geot_tpu_torch.graph.preprocess import (
    add_self_loops,
    degree,
    gcn_norm,
    sort_edges_by_dst,
)
from geot_tpu_torch.graph.stream_plan import (
    HybridPlan,
    StreamKnobs,
    StreamPlan,
    build_stream_split_host,
    cell_census,
)
from geot_tpu_torch.graph.structures import Graph, build_graph

__all__ = [
    "DATASET_SHAPES",
    "GraphData",
    "synthetic_graph",
    "synthetic_clustered_graph",
    "BatPlan",
    "build_bat_plan",
    "build_bat_plan_host",
    "compute_chunks",
    "add_self_loops",
    "degree",
    "gcn_norm",
    "sort_edges_by_dst",
    "HybridPlan",
    "StreamKnobs",
    "StreamPlan",
    "build_stream_split_host",
    "cell_census",
    "Graph",
    "build_graph",
]
