"""Spatial methods (counterpart: dance_tpu/modules/spatial/)."""
