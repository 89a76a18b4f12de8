"""The one ``SetConfig`` step that is each multimodal model's pipeline on a
``MuData`` with modalities ``mod1`` and ``mod2`` (counterparts: the
``preprocessing_pipeline`` of predict_modality/{scmogcn,babel,cmae,scmm}.py
and joint_embedding/{scmogcn,scmogcnv2,dcca,jae,scmvae}.py). The dicts keep
JAX's key order, so that the digests are JAX's."""

from dance_tpu_torch.transforms.misc import SetConfig


def predict_modality_config(log_level: str = "INFO") -> SetConfig:
    """``mod1``'s ``X`` is the features and ``mod2``'s ``X`` the labels
    (counterpart: predict_modality/scmogcn.py:478, babel.py:78, cmae.py:92,
    scmm.py:101)."""
    return SetConfig({"feature_mod": "mod1", "label_mod": "mod2",
                      "feature_channel": None, "feature_channel_type": "X",
                      "label_channel": None, "label_channel_type": "X"}, log_level=log_level)


def joint_embedding_config(log_level: str = "INFO") -> SetConfig:
    """Both modalities' ``X`` are the features and ``mod1``'s
    ``obs["cell_type"]`` the labels (counterpart: joint_embedding/
    scmogcn.py:60, scmogcnv2.py:264, dcca.py:165, jae.py:85, scmvae.py:322)."""
    return SetConfig({"feature_mod": ["mod1", "mod2"],
                      "feature_channel": [None, None],
                      "feature_channel_type": ["X", "X"],
                      "label_mod": "mod1", "label_channel": "cell_type",
                      "label_channel_type": "obs"}, log_level=log_level)


__all__ = ["joint_embedding_config", "predict_modality_config"]
