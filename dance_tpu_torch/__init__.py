"""dance-tpu on PyTorch: the port of :mod:`dance_tpu` to PyTorch and CUDA.

The JAX package (``dance_tpu/``) is the reference; every module here names
its counterpart by file and line. Plain tensor code is PyTorch, and every
Pallas kernel that the main path runs is a CUDA kernel written by hand for
Hopper (``csrc/``), built with ``nvcc`` at first use (:mod:`.ops._build`).

At run time this package imports torch, numpy, scipy and the standard
library only: never JAX, flax, optax, scikit-learn, pandas, h5py, yaml or
``dance_tpu``.

Counterpart: dance_tpu/__init__.py:15-19.
"""

import torch

from dance_tpu_torch.settings import logger

# PyTorch's CPU math sets up its vectorised transcendental functions at their
# first use. When that first use is a call split over several threads, some
# elements of that one call have come out ~1e-4 off (seen for torch.exp of a
# (13, 128, 128) tensor in about one test process of six; every later call is
# right to an ulp). One small call on one thread settles it before the plain
# versions of the kernels run on the CPU (ROADMAP Queue 3).
torch.exp(torch.zeros(8))

__version__ = "0.1.0"

__all__ = ["logger", "__version__"]
