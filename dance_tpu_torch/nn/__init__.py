"""Graph neural layers, the MLP, the full-batch norm and the ZINB heads'
activations (counterpart: dance_tpu/nn/__init__.py)."""

from dance_tpu_torch.nn.gnn import AdaptiveSAGE, GATConv, TAGConv, WeightedGraphConv
from dance_tpu_torch.nn.mlp import FullBatchNorm, VanillaMLP, buildNetwork
from dance_tpu_torch.nn.zinb_ae import disp_act, mean_act

__all__ = ["AdaptiveSAGE", "FullBatchNorm", "GATConv", "TAGConv", "VanillaMLP",
           "WeightedGraphConv", "buildNetwork", "disp_act", "mean_act"]
