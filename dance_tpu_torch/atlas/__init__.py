"""The atlas's dataset-similarity backend (counterpart: dance_tpu/atlas)."""

from dance_tpu_torch.atlas.sc_similarity.anndata_similarity import AnnDataSimilarity

__all__ = ["AnnDataSimilarity"]
