"""Single-modality methods (counterpart:
dance_tpu/modules/single_modality/__init__.py)."""
