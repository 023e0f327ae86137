from geot_tpu_torch.models.basic_gnn import GAT, GCN, MODELS, BasicGNN, GraphSAGE
from geot_tpu_torch.models.conv import (
    GATConv,
    GCNConv,
    SAGEConv,
    gcn_edge_weight,
    prepare_graph,
)
from geot_tpu_torch.models.train import (
    accuracy,
    cross_entropy_loss,
    load_checkpoint,
    make_optimizer,
    make_train_step,
    save_checkpoint,
    train_node_classifier,
)
from geot_tpu_torch.models.weights import params_from_flax, params_to_flax

__all__ = [
    "GCN",
    "GraphSAGE",
    "GAT",
    "MODELS",
    "BasicGNN",
    "GCNConv",
    "SAGEConv",
    "GATConv",
    "gcn_edge_weight",
    "prepare_graph",
    "params_from_flax",
    "params_to_flax",
    "cross_entropy_loss",
    "accuracy",
    "make_optimizer",
    "make_train_step",
    "train_node_classifier",
    "save_checkpoint",
    "load_checkpoint",
]
