"""Joint embedding (counterpart:
dance_tpu/modules/multi_modality/joint_embedding/__init__.py). Ported so far:
scMoGNN."""

from dance_tpu_torch.modules.multi_modality.joint_embedding.scmogcn import ScMoGCNWrapper

__all__ = ["ScMoGCNWrapper"]
