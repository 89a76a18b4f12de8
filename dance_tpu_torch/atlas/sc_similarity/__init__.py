from dance_tpu_torch.atlas.sc_similarity.anndata_similarity import AnnDataSimilarity

__all__ = ["AnnDataSimilarity"]
