"""Methods (counterpart: dance_tpu/modules/__init__.py)."""
