"""Graph neural layers, the MLP, the full-batch norm and the ZINB
autoencoder with its heads' activations (counterpart:
dance_tpu/nn/__init__.py)."""

from dance_tpu_torch.nn.gnn import AdaptiveSAGE, GATConv, TAGConv, WeightedGraphConv
from dance_tpu_torch.nn.mlp import FullBatchNorm, VanillaMLP, buildNetwork
from dance_tpu_torch.nn.zinb_ae import (DispAct, MeanAct, MLPStack, TorchDense, ZINBAutoencoder,
                                        disp_act, mean_act)

__all__ = ["AdaptiveSAGE", "DispAct", "FullBatchNorm", "GATConv", "MLPStack", "MeanAct",
           "TAGConv", "TorchDense", "VanillaMLP", "WeightedGraphConv", "ZINBAutoencoder",
           "buildNetwork", "disp_act", "mean_act"]
