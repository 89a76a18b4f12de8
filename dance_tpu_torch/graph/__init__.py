"""JAX-free graph container (counterpart: dance_tpu/graph/__init__.py)."""

from dance_tpu_torch.graph.base import DeviceGraph, Graph

__all__ = ["DeviceGraph", "Graph"]
