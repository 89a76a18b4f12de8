"""Data layer: pandas-free AnnData/MuData containers and the split-aware Data
wrapper (counterpart: dance_tpu/data/__init__.py)."""

from dance_tpu_torch.data.base import BaseData, Data
from dance_tpu_torch.data.container import AnnData, Frame, MuData, Raw, concat
from dance_tpu_torch.data.io import read_h5ad, read_h5mu, write_h5ad, write_h5mu

__all__ = ["AnnData", "BaseData", "Data", "Frame", "MuData", "Raw", "concat", "read_h5ad",
           "read_h5mu", "write_h5ad", "write_h5mu"]
