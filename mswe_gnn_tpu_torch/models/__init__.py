"""Models of the port: the MSGNN V-cycle over SWEGNN layers, the
single-scale GNN (SWEGNN or a Cheb / TAG / GAT baseline) and MeshGraphNets."""
from mswe_gnn_tpu_torch.models.gnn import GNNConfig, apply_gnn, init_gnn
from mswe_gnn_tpu_torch.models.meshgraphnet import MGNConfig, apply_mgn, init_mgn
from mswe_gnn_tpu_torch.models.msgnn import MSGNNConfig, apply_msgnn, init_msgnn
from mswe_gnn_tpu_torch.models.prepare import prepare_graph
from mswe_gnn_tpu_torch.models.registry import build_model, count_params
from mswe_gnn_tpu_torch.models.swegnn import (SWEGNNConfig, apply_swegnn, apply_swegnn_block,
                                              init_swegnn)

__all__ = ["GNNConfig", "MGNConfig", "MSGNNConfig", "SWEGNNConfig", "apply_gnn", "apply_mgn",
           "apply_msgnn", "apply_swegnn", "apply_swegnn_block", "build_model", "count_params",
           "init_gnn", "init_mgn", "init_msgnn", "init_swegnn", "prepare_graph"]
