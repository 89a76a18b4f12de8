"""Graph neural layers (counterpart: dance_tpu/nn/__init__.py)."""

from dance_tpu_torch.nn.gnn import AdaptiveSAGE, GATConv

__all__ = ["AdaptiveSAGE", "GATConv"]
