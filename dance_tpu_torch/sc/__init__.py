"""scanpy-style preprocessing on arrays (counterpart: dance_tpu/sc/)."""
