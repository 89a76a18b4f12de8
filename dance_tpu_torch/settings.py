"""Package logger (counterpart: dance_tpu/settings.py:7-30).

The JAX package's XLA compilation-cache settings have no counterpart: the
port runs eagerly and builds its CUDA kernels once per source hash
(:mod:`dance_tpu_torch.ops._build`).
"""

import logging
import os

LOGGER_NAME = "dance_tpu_torch"

logger = logging.getLogger(LOGGER_NAME)
if not logger.handlers:  # idempotent under re-import
    _handler = logging.StreamHandler()
    _handler.setFormatter(
        logging.Formatter("[%(levelname)s][%(asctime)s][%(name)s][%(funcName)s] %(message)s"))
    logger.addHandler(_handler)
    logger.setLevel(os.environ.get("DANCE_LOG_LEVEL", "INFO").upper())
    logger.propagate = False

