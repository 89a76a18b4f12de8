"""flax -> torch parameter transfer for the scDeepSort ``GNN``, STAGATE's
net and ``GATConv``.

Parity between the two packages is checked by copying the flax parameters
into the torch module, since the two frameworks' generators and initializers
differ. Counterpart of the flax tree made by ``GNN.init``
(dance_tpu/modules/single_modality/cell_type_annotation/scdeepsort.py:30-49):

    alpha                                   -> alpha
    AdaptiveSAGE_{i}/Dense_0/{kernel,bias}  -> layers.{i}.linear.{weight,bias}
    AdaptiveSAGE_{i}/LayerNorm_0/{scale,bias} -> layers.{i}.norm.{weight,bias}
    Dense_0/{kernel,bias}                   -> head.{weight,bias}

flax ``Dense.kernel`` is (in, out); torch ``Linear.weight`` is (out, in).

STAGATE's ``_StagateNet`` (stagate.py:57-87) keeps ``w1``, ``w2``, ``a1l`` and
``a1r`` as raw parameters used as ``x @ w1``; they map onto
:class:`~dance_tpu_torch.modules.spatial.spatial_domain.stagate.StagateNet`
as they are. ``GATConv`` (dance_tpu/nn/gnn.py:166): ``Dense_0/kernel`` ->
``linear.weight`` (transposed), ``attn_l`` and ``attn_r`` as they are.
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


def stagate_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``_StagateNet`` tree -> ``StagateNet.state_dict()``."""
    return {k: _t(params[k]) for k in ("w1", "w2", "a1l", "a1r")}


def gatconv_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``GATConv`` tree -> ``GATConv.state_dict()``."""
    return {"linear.weight": _t(np.asarray(params["Dense_0"]["kernel"]).T),
            "attn_l": _t(params["attn_l"]), "attn_r": _t(params["attn_r"])}


__all__ = ["flax_to_torch", "gatconv_flax_to_torch", "stagate_flax_to_torch"]
