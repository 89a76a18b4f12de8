"""Multimodal methods (counterpart: dance_tpu/modules/multi_modality). Ported
so far: scMoGNN for modality prediction, modality matching and joint
embedding."""
