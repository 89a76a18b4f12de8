"""flax -> torch parameter transfer for the scDeepSort ``GNN``.

Parity between the two packages is checked by copying the flax parameters
into the torch module, since the two frameworks' generators and initializers
differ. Counterpart of the flax tree made by ``GNN.init``
(dance_tpu/modules/single_modality/cell_type_annotation/scdeepsort.py:30-49):

    alpha                                   -> alpha
    AdaptiveSAGE_{i}/Dense_0/{kernel,bias}  -> layers.{i}.linear.{weight,bias}
    AdaptiveSAGE_{i}/LayerNorm_0/{scale,bias} -> layers.{i}.norm.{weight,bias}
    Dense_0/{kernel,bias}                   -> head.{weight,bias}

flax ``Dense.kernel`` is (in, out); torch ``Linear.weight`` is (out, in).
"""

from typing import Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """Map a flax ``GNN`` parameter tree (leaves convertible with
    ``np.asarray``) to a ``state_dict`` for :class:`~dance_tpu_torch.modules.
    single_modality.cell_type_annotation.scdeepsort.GNN`."""
    state = {"alpha": _t(params["alpha"]),
             "head.weight": _t(np.asarray(params["Dense_0"]["kernel"]).T),
             "head.bias": _t(params["Dense_0"]["bias"])}
    n_layers = sum(1 for k in params if k.startswith("AdaptiveSAGE_"))
    for i in range(n_layers):
        layer = params[f"AdaptiveSAGE_{i}"]
        state[f"layers.{i}.linear.weight"] = _t(np.asarray(layer["Dense_0"]["kernel"]).T)
        state[f"layers.{i}.linear.bias"] = _t(layer["Dense_0"]["bias"])
        state[f"layers.{i}.norm.weight"] = _t(layer["LayerNorm_0"]["scale"])
        state[f"layers.{i}.norm.bias"] = _t(layer["LayerNorm_0"]["bias"])
    return state


__all__ = ["flax_to_torch"]
