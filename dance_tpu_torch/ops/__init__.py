"""Sparse containers, the BSR kernels' host side and wrappers, segment ops
and linear algebra (counterpart: dance_tpu/ops/__init__.py)."""
