"""Joint embedding (counterpart:
dance_tpu/modules/multi_modality/joint_embedding/__init__.py). Ported so far:
scMoGNN, and scMoGNN v2 (``scmogcnv2.ScMoGCNWrapperV2``, which the JAX
package does not export here either). Not yet: DCCA, JAE, scMVAE."""

from dance_tpu_torch.modules.multi_modality.joint_embedding.scmogcn import ScMoGCNWrapper

__all__ = ["ScMoGCNWrapper"]
