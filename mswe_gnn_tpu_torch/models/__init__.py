"""Models of the port: the MSGNN V-cycle over SWEGNN layers."""
from mswe_gnn_tpu_torch.models.msgnn import MSGNNConfig, apply_msgnn, init_msgnn
from mswe_gnn_tpu_torch.models.prepare import prepare_graph
from mswe_gnn_tpu_torch.models.registry import build_model, count_params
from mswe_gnn_tpu_torch.models.swegnn import SWEGNNConfig, apply_swegnn_block, init_swegnn

__all__ = ["MSGNNConfig", "SWEGNNConfig", "apply_msgnn", "apply_swegnn_block",
           "build_model", "count_params", "init_msgnn", "init_swegnn",
           "prepare_graph"]
