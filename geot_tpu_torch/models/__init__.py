from geot_tpu_torch.models.basic_gnn import GCN, BasicGNN
from geot_tpu_torch.models.conv import GCNConv, gcn_edge_weight, prepare_graph
from geot_tpu_torch.models.weights import params_from_flax

__all__ = [
    "GCN",
    "BasicGNN",
    "GCNConv",
    "gcn_edge_weight",
    "prepare_graph",
    "params_from_flax",
]
