"""Multimodal methods (counterpart: dance_tpu/modules/multi_modality). Ported
so far: BABEL, CMAE, scMM and scMoGNN for modality prediction; CMAE, scMM
and scMoGNN for modality matching; scMoGNN and scMoGNN v2 for joint
embedding."""
