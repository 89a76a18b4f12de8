"""Joint embedding (counterpart:
dance_tpu/modules/multi_modality/joint_embedding/__init__.py): DCCA, JAE,
scMoGNN and scMVAE, and scMoGNN v2 (``scmogcnv2.ScMoGCNWrapperV2``, which the
JAX package does not export here either)."""

from dance_tpu_torch.modules.multi_modality.joint_embedding.dcca import DCCA
from dance_tpu_torch.modules.multi_modality.joint_embedding.jae import JAEWrapper
from dance_tpu_torch.modules.multi_modality.joint_embedding.scmogcn import ScMoGCNWrapper
from dance_tpu_torch.modules.multi_modality.joint_embedding.scmvae import scMVAE

__all__ = ["DCCA", "JAEWrapper", "ScMoGCNWrapper", "scMVAE"]
