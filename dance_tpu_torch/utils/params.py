"""flax -> torch parameter transfer for the scDeepSort ``GNN``, STAGATE's
net, ``GATConv``, ``GCNConv``, ``SAGEConv``, graph-sc's ``GCNAE``, scTAG's net, scDSC's model, the
scMoGNN trunk, matching net and v2 net, DSTG's GCN, stdGCN's network and
autoencoder, scHeteroNet's network, GraphSCI's network, ACTINN's MLP, the ZINB
autoencoder of scDeepCluster and scDCC, DeepImpute's stacked ensemble, the
BABEL, CMAE and scMM nets, DCCA's, JAE's and scMVAE's, EfNST's graph
autoencoder, scGNN2's feature and graph autoencoders, and the morphology
encoder's kernels and decoder.

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
graph-sc's ``GCNAE`` (graphsc.py:29-57):

    WeightedGraphConv_{i}/Dense_0/kernel -> convs.{i}.linear.weight
    WeightedGraphConv_{i}/bias           -> convs.{i}.bias
    Dense_{k}/{kernel,bias}              -> denses.{k}.{weight,bias}

scTAG's ``_ScTAGNet`` (sctag.py:32-63; ``TAGConv`` gnn.py:206 names its
kernels compactly, ``Dense_0`` with the bias and ``Dense_1 .. Dense_k``
without):

    encoder{1,2}/Dense_{i}/kernel        -> encoder{1,2}.linears.{i}.weight
    encoder{1,2}/Dense_0/bias            -> encoder{1,2}.linears.0.bias
    dec_stack_{i}/{kernel,bias}          -> dec_stack.{i}.{weight,bias}
    dec_{mean,disp,pi}/{kernel,bias}     -> dec_{mean,disp,pi}.{weight,bias}

scDSC's ``ScDSCModel`` (scdsc.py:32-104):

    ae/{enc,zs,dec}_{i}/{kernel,bias}    -> ae.{enc,zs,dec}.{i}.{weight,bias}
    ae/out/{kernel,bias}                 -> ae.out.{weight,bias}
    gnn_{i}/kernel                       -> gnn.{i}.weight
    dec_{mean,disp,pi}/{kernel,bias}     -> dec_{mean,disp,pi}.{weight,bias}
    cluster_layer                        -> cluster_layer

The scMoGNN trunk ``ScMoGCN`` (predict_modality/scmogcn.py:227-305; flax
names a list of modules ``name_{i}``):

    embed_feat/embedding                 -> embed_feat.weight
    embed_cell/embedding, or {kernel,bias} (cell_init="svd") -> embed_cell.*
    conv_{f2c,c2f,pw}_{i}/Dense_0, Dense_1 (mean: self without bias, then
        neighbour; gcn: Dense_0 alone, the neighbour) -> conv_*.{i}.fc_{self,neigh}
    {conv_norm,cell_input_norm,feat_input_norm}_{j}/{GroupNorm_0,LayerNorm_0}
        -> ....{j}.norm.{weight,bias}; the batch norm's own scale, bias as they are
    {att_linears,readout_linears,cell_input_linears,feat_input_linears}_{i}
        -> ....{i}.{weight,bias}
    extra_encoder                        -> extra_encoder
    wt, aph                              -> wt, aph

and the joint-embedding net ``_JENet`` (joint_embedding/scmogcn.py:25):
``trunk/...`` -> ``trunk.…`` as above, ``head`` -> ``head``. The matching
net ``ScMoGCN`` (match_modality/scmogcn.py:89) names its layers by their
place among a stack's modules (``Dense``, ``gelu``, ``Dropout`` ...), and
JAX keeps the hop logits beside it:

    model/stacks_{j}_{k}/{kernel,bias}   -> stacks.{j}.{i}.{weight,bias}, i the
                                            k-th Dense's rank in stack j
    wt1, wt2                             -> wt1, wt2

DSTG's ``_GCN`` (dstg.py:30): ``Dense_{i}/kernel`` -> ``dense_{i}.weight``.
stdGCN's ``_ConGCN`` (stdgcn.py:225) names its layers in call order: with
``c`` common and ``f`` head hidden layers, tower layer ``l`` of the
expression tower is ``Dense_{2l}`` and ``_FullBatchNorm_{2l}``, of the
spatial tower ``Dense_{2l+1}`` and ``_FullBatchNorm_{2l+1}``; head layer
``m`` is ``Dense_{2c+2+m}`` with its norm; the output ``Dense_{2c+f+3}``:

    Dense_{i}/{kernel,bias}              -> {exp,sp,fc}.{l}.{weight,bias}, out.*
    _FullBatchNorm_{i}/{scale,bias}      -> {exp,sp,fc}_norm.{l}.{scale,bias}

stdGCN's ``autoencoder`` (stdgcn.py:535), flax ``Sequential``s of
``full_block``s:

    {encoder,decoder}/layers_{i}/layers_0/{kernel,bias} -> {encoder,decoder}.{i}.0.*
    {encoder,decoder}/layers_{i}/layers_1/{scale,bias}  -> {encoder,decoder}.{i}.1.{weight,bias}

scHeteroNet's ``_HeteroNet`` (scheteronet.py:101; ``setup`` names its
layers, the decoder's compact ``Dense`` layers are numbered in call order):

    feature_embed, final_project         -> feature_embed.*, final_project.*
    bns_{i}/{scale,bias}                 -> bns.{i}.{scale,bias}
    decoder/Dense_{0,1}                  -> decoder.hidden.{0,1}
    decoder/Dense_{2,3,4}                -> decoder.{mean,disp,pi}

GraphSCI's ``_GraphSCINet`` (graphsci.py:125): ``gnn/{w,b}{1,2,_mean,_log_std}``
as they are (raw ``x @ w`` parameters), ``ae/mul_fc/kernel`` ->
``ae.mul_fc.weight`` (no bias), ``ae/mul_bias`` as it is,
``ae/{enc1,enc2,dec_pi,dec_disp,dec_mean}`` as ``Dense`` layers and
``ae/{bn1,bn2}/{scale,bias}`` as they are.

ACTINN's ``VanillaMLP`` (mlp.py:13): ``Dense_{i}`` -> ``layers.{i}``. The
``ZINBAutoencoder`` (zinb_ae.py:61), whose every layer is a ``TorchDense``
wrapping one ``Dense_0``:

    {encoder,decoder}/TorchDense_{i}/Dense_0 -> {encoder,decoder}.layers.{i}
    {enc_mu,dec_mean,dec_disp,dec_pi}/Dense_0 -> {enc_mu,dec_mean,dec_disp,dec_pi}

DeepImpute's ensemble (deepimpute.py:31), the subnets' trees stacked on a
leading axis by ``jax.vmap``: ``Dense_{0,1}`` (or, in the reference
protocol, ``TorchDense_{0,1}/Dense_0``) ``/kernel`` (n_ens, in, out) ->
``w{1,2}`` as they are (the port computes ``x @ w`` per subnet), ``/bias``
-> ``b{1,2}``.

The multimodal autoencoders. An ``MLPStack`` is ``TorchDense_{i}/Dense_0``
-> ``layers.{i}``; the VAE blocks (nn/vae.py) name their stack
``MLPStack_0`` -> ``stack`` and their heads in call order: ``Dense_0``,
``Dense_1`` -> ``mu``, ``logvar`` (``GaussianEncoder``), ``mean``, ``disp``
(``NBDecoder``), ``Dense_0`` -> ``out`` (``GaussianDecoder``). BABEL's
``_Babel`` (babel.py:30): ``enc1``, ``enc2``, ``dec2_stack`` stacks,
``dec1`` an ``NBDecoder``, ``dec2_out`` a ``Dense``. CMAE's ``_CMAENet``
(cmae.py:28): ``{enc,dec}{1,2}`` stacks and ``{enc,dec}{1,2}_out``; its
``_Disc`` (cmae.py:63): ``Dense_0``, ``Dense_1`` -> ``hidden``, ``out``.
scMM's ``_MMVAENet`` (scmm.py:28): ``enc1``, ``enc2`` Gaussian encoders,
``dec1`` NB, ``dec2`` Gaussian. scMoGNN v2's ``_ScMoGCNv2Net``
(scmogcnv2.py:51): ``trunk/...`` as the trunk above (it has no readout),
``decoder_{i}`` -> ``decoder.{i}``, ``c_decoder``, ``cc_decoder``.

The joint-embedding autoencoders. DCCA's ``_ModalityVAE`` (dcca.py:43):
``{encoder,decoder}/Dense_{i}`` -> ``{encoder,decoder}.layers.{i}``, and
``fc_mean``, ``fc_logvar``, ``dec_scale``, ``dec_disp``, ``dec_drop`` as
``Dense`` layers. JAE's ``_JAE`` (jae.py:39): ``enc_layers_{i}`` ->
``enc_layers.{i}``, ``enc_norms_{i}/{scale,bias}`` -> ``enc_norms.{i}.*``,
``enc_out``, ``dec1``, ``dec2``. scMVAE's ``_scMVAENet`` (scmvae.py:153):

    {enc1,enc2,enc_l1,enc_l2}/_MLP_0/Dense_{i} -> {...}.mlp.layers.{i}
    {enc1,...}/Dense_{0,1}               -> {...}.{mu,logvar}
    share/Dense_{i}                      -> share.layers.{i}
    {dec1,dec2}/_MLP_0/Dense_{i}         -> {dec1,dec2}.mlp.layers.{i}
    dec1/Dense_{0,1,2} (ZINB dec2 too)   -> dec1.{scale,disp,dropout}
    dec2/Dense_0 (the plain decoders)    -> dec2.out
    pi_logit, mu_c, logvar_c             -> as they are
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


def graphsc_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``GCNAE`` tree -> ``GCNAE.state_dict()``."""
    state = {}
    for name, sub in params.items():
        kind, _, idx = name.rpartition("_")
        if kind == "WeightedGraphConv":
            state[f"convs.{idx}.linear.weight"] = _t(np.asarray(sub["Dense_0"]["kernel"]).T)
            state[f"convs.{idx}.bias"] = _t(sub["bias"])
        elif kind == "Dense":
            state[f"denses.{idx}.weight"] = _t(np.asarray(sub["kernel"]).T)
            state[f"denses.{idx}.bias"] = _t(sub["bias"])
        else:
            raise KeyError(f"unexpected GCNAE parameter {name!r}")
    return state


def _dense(state: dict, prefix: str, sub: Mapping, bias: bool = True):
    """One flax ``Dense`` into ``{prefix}.weight`` (transposed) and ``.bias``;
    raise on any other leaf."""
    extra = set(sub) - ({"kernel", "bias"} if bias else {"kernel"})
    if extra or "kernel" not in sub:
        raise KeyError(f"unexpected Dense parameters {sorted(sub)} under {prefix!r}")
    state[f"{prefix}.weight"] = _t(np.asarray(sub["kernel"]).T)
    if "bias" in sub:
        state[f"{prefix}.bias"] = _t(sub["bias"])


def gcnconv_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``GCNConv`` tree (``Dense_0``) -> ``GCNConv.state_dict()``."""
    if set(params) != {"Dense_0"}:
        raise KeyError(f"unexpected GCNConv parameters {sorted(params)}")
    state = {}
    _dense(state, "linear", params["Dense_0"])
    return state


def sageconv_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``SAGEConv`` tree -> ``SAGEConv.state_dict()``: ``Dense_0``
    (on the node itself) -> ``fc_self``, ``Dense_1`` (on the neighbours'
    mean, no bias) -> ``fc_neigh``."""
    if set(params) != {"Dense_0", "Dense_1"}:
        raise KeyError(f"unexpected SAGEConv parameters {sorted(params)}")
    state = {}
    _dense(state, "fc_self", params["Dense_0"])
    _dense(state, "fc_neigh", params["Dense_1"], bias=False)
    return state


def tagconv_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``TAGConv`` tree -> ``TAGConv.state_dict()``."""
    state = {}
    for dense, leaves in params.items():
        kind, _, i = dense.rpartition("_")
        if kind != "Dense":
            raise KeyError(f"unexpected TAGConv parameter {dense!r}")
        _dense(state, f"linears.{i}", leaves, bias=i == "0")
    return state


def sctag_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``_ScTAGNet`` tree -> ``_ScTAGNet.state_dict()``."""
    state = {}
    for name, sub in params.items():
        kind, _, idx = name.rpartition("_")
        if name in ("encoder1", "encoder2"):
            state.update({f"{name}.{k}": v for k, v in tagconv_flax_to_torch(sub).items()})
        elif kind == "dec_stack":
            _dense(state, f"dec_stack.{idx}", sub)
        elif name in ("dec_mean", "dec_disp", "dec_pi"):
            _dense(state, name, sub)
        else:
            raise KeyError(f"unexpected _ScTAGNet parameter {name!r}")
    return state


def scdsc_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``ScDSCModel`` tree -> ``ScDSCModel.state_dict()``."""
    state = {}
    for name, sub in params.items():
        kind, _, idx = name.rpartition("_")
        if name == "ae":
            for layer, leaves in sub.items():
                lkind, _, i = layer.rpartition("_")
                if layer == "out":
                    _dense(state, "ae.out", leaves)
                elif lkind in ("enc", "zs", "dec"):
                    _dense(state, f"ae.{lkind}.{i}", leaves)
                else:
                    raise KeyError(f"unexpected _AE parameter {layer!r}")
        elif kind == "gnn":
            _dense(state, f"gnn.{idx}", sub, bias=False)
        elif name in ("dec_mean", "dec_disp", "dec_pi"):
            _dense(state, name, sub)
        elif name == "cluster_layer":
            state[name] = _t(sub)
        else:
            raise KeyError(f"unexpected ScDSCModel parameter {name!r}")
    return state


_SCMOGCN_LISTS = ("conv_f2c", "conv_c2f", "conv_pw", "conv_norm", "cell_input_norm",
                  "feat_input_norm", "att_linears", "readout_linears", "cell_input_linears",
                  "feat_input_linears")


def _norm(state: dict, prefix: str, sub: Mapping):
    """A ``_Norm``: flax's GroupNorm_0 / LayerNorm_0, or the batch norm's own
    ``scale`` and ``bias``."""
    if set(sub) <= {"scale", "bias"}:
        for k in sub:
            state[f"{prefix}.{k}"] = _t(sub[k])
        return
    (name, leaves), = sub.items()
    if name not in ("GroupNorm_0", "LayerNorm_0") or set(leaves) - {"scale", "bias"}:
        raise KeyError(f"unexpected _Norm parameters {sorted(sub)} under {prefix!r}")
    state[f"{prefix}.norm.weight"] = _t(leaves["scale"])
    state[f"{prefix}.norm.bias"] = _t(leaves["bias"])


def scmogcn_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``ScMoGCN`` tree -> ``ScMoGCN.state_dict()`` (the modules flax
    created: an unused one, such as the pathway norms of ``"sum"``, has no
    flax parameters and keeps its torch ones)."""
    state = {}
    for name, sub in params.items():
        kind, _, idx = name.rpartition("_")
        if name in ("wt", "aph"):
            state[name] = _t(sub)
        elif name in ("embed_feat", "embed_cell") and set(sub) == {"embedding"}:
            state[f"{name}.weight"] = _t(sub["embedding"])
        elif name in ("embed_cell", "extra_encoder"):
            _dense(state, name, sub)
        elif kind in ("conv_f2c", "conv_c2f", "conv_pw"):
            if "Dense_1" in sub:  # mean: Dense_0 the self weight, Dense_1 the neighbour's
                if set(sub) != {"Dense_0", "Dense_1"}:
                    raise KeyError(f"unexpected _SAGERelation parameters {sorted(sub)}")
                _dense(state, f"{kind}.{idx}.fc_self", sub["Dense_0"], bias=False)
                _dense(state, f"{kind}.{idx}.fc_neigh", sub["Dense_1"])
            elif set(sub) == {"Dense_0"}:  # gcn
                _dense(state, f"{kind}.{idx}.fc_neigh", sub["Dense_0"])
            else:
                raise KeyError(f"unexpected _SAGERelation parameters {sorted(sub)}")
        elif kind in ("conv_norm", "cell_input_norm", "feat_input_norm"):
            _norm(state, f"{kind}.{idx}", sub)
        elif kind in _SCMOGCN_LISTS:
            _dense(state, f"{kind}.{idx}", sub)
        else:
            raise KeyError(f"unexpected ScMoGCN parameter {name!r}")
    return state


def scmogcn_je_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax joint-embedding ``_JENet`` tree -> ``_JENet.state_dict()``."""
    state = {}
    for name, sub in params.items():
        if name == "trunk":
            state.update({f"trunk.{k}": v for k, v in scmogcn_flax_to_torch(sub).items()})
        elif name == "head":
            _dense(state, "head", sub)
        else:
            raise KeyError(f"unexpected _JENet parameter {name!r}")
    return state


def scmogcn_match_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """``{"model": <ScMoGCN params>, "wt1", "wt2"}`` (the matching fit's
    params, match_modality/scmogcn.py:321-325) -> the port's ``ScMoGCN``."""
    dense: Dict[int, list] = {}
    for key in params["model"]:
        parts = key.split("_")
        if len(parts) != 3 or parts[0] != "stacks":
            raise KeyError(f"unexpected ScMoGCN parameter {key!r}")
        dense.setdefault(int(parts[1]), []).append((int(parts[2]), key))
    state = {}
    for j, keys in dense.items():
        for i, (_, key) in enumerate(sorted(keys)):
            _dense(state, f"stacks.{j}.{i}", params["model"][key])
    state["wt1"], state["wt2"] = _t(params["wt1"]), _t(params["wt2"])
    return state


def dstg_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax DSTG ``_GCN`` tree -> ``_GCN.state_dict()``."""
    state = {}
    for name, sub in params.items():
        kind, _, idx = name.rpartition("_")
        if kind != "Dense" or idx not in ("0", "1"):
            raise KeyError(f"unexpected _GCN parameter {name!r}")
        _dense(state, f"dense_{idx}", sub, bias=False)
    return state


def stdgcn_flax_to_torch(params: Mapping, common_hid_layers_num: int = 1,
                         fcnn_hid_layers_num: int = 1) -> Dict[str, torch.Tensor]:
    """A flax stdGCN ``_ConGCN`` tree -> ``_ConGCN.state_dict()``."""
    c, f = common_hid_layers_num, fcnn_hid_layers_num
    names = {}
    for layer in range(c + 1):
        names[2 * layer], names[2 * layer + 1] = f"exp.{layer}", f"sp.{layer}"
    for m in range(f + 1):
        names[2 * c + 2 + m] = f"fc.{m}"
    state = {}
    for name, sub in params.items():
        kind, _, idx = name.rpartition("_")
        i = int(idx)
        if kind == "Dense" and i == 2 * c + f + 3:
            _dense(state, "out", sub)
        elif kind == "Dense" and i in names:
            _dense(state, names[i], sub)
        elif kind == "_FullBatchNorm" and i in names and set(sub) == {"scale", "bias"}:
            tower, layer = names[i].split(".")
            state[f"{tower}_norm.{layer}.scale"] = _t(sub["scale"])
            state[f"{tower}_norm.{layer}.bias"] = _t(sub["bias"])
        else:
            raise KeyError(f"unexpected _ConGCN parameter {name!r}")
    return state


def autoencoder_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax stdGCN ``autoencoder`` tree -> ``autoencoder.state_dict()``."""
    state = {}
    for half in ("encoder", "decoder"):
        for block, sub in params[half].items():
            i = block.rpartition("_")[2]
            _dense(state, f"{half}.{i}.0", sub["layers_0"])
            state[f"{half}.{i}.1.weight"] = _t(sub["layers_1"]["scale"])
            state[f"{half}.{i}.1.bias"] = _t(sub["layers_1"]["bias"])
    if set(params) != {"encoder", "decoder"}:
        raise KeyError(f"unexpected autoencoder parameters {sorted(params)}")
    return state


_HETERONET_DECODER = {"Dense_0": "hidden.0", "Dense_1": "hidden.1", "Dense_2": "mean",
                      "Dense_3": "disp", "Dense_4": "pi"}


def scheteronet_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax scHeteroNet ``_HeteroNet`` tree -> ``_HeteroNet.state_dict()``."""
    state = {}
    for name, sub in params.items():
        kind, _, idx = name.rpartition("_")
        if name in ("feature_embed", "final_project"):
            _dense(state, name, sub)
        elif kind == "bns" and set(sub) == {"scale", "bias"}:
            state[f"bns.{idx}.scale"], state[f"bns.{idx}.bias"] = _t(sub["scale"]), _t(sub["bias"])
        elif name == "decoder" and set(sub) <= set(_HETERONET_DECODER):
            for dense, leaves in sub.items():
                _dense(state, f"decoder.{_HETERONET_DECODER[dense]}", leaves)
        else:
            raise KeyError(f"unexpected _HeteroNet parameter {name!r}")
    return state


_GRAPHSCI_GNN = {f"{p}{s}" for p in "wb" for s in ("1", "2", "_mean", "_log_std")}


def graphsci_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax GraphSCI ``_GraphSCINet`` tree -> ``_GraphSCINet.state_dict()``."""
    if set(params) != {"gnn", "ae"} or set(params["gnn"]) != _GRAPHSCI_GNN:
        raise KeyError(f"unexpected _GraphSCINet parameters {sorted(params)}")
    state = {f"gnn.{k}": _t(v) for k, v in params["gnn"].items()}
    for name, sub in params["ae"].items():
        if name == "mul_fc":
            _dense(state, "ae.mul_fc", sub, bias=False)
        elif name == "mul_bias":
            state["ae.mul_bias"] = _t(sub)
        elif name in ("enc1", "enc2", "dec_pi", "dec_disp", "dec_mean"):
            _dense(state, f"ae.{name}", sub)
        elif name in ("bn1", "bn2") and set(sub) == {"scale", "bias"}:
            state[f"ae.{name}.scale"], state[f"ae.{name}.bias"] = _t(sub["scale"]), _t(sub["bias"])
        else:
            raise KeyError(f"unexpected _AEModel parameter {name!r}")
    return state


def actinn_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``VanillaMLP`` tree -> ``VanillaMLP.state_dict()``."""
    state = {}
    for name, sub in params.items():
        kind, _, idx = name.rpartition("_")
        if kind != "Dense":
            raise KeyError(f"unexpected VanillaMLP parameter {name!r}")
        _dense(state, f"layers.{idx}", sub)
    return state


def _torch_dense(state: dict, prefix: str, sub: Mapping):
    """A flax ``TorchDense``: its one ``Dense_0``."""
    if set(sub) != {"Dense_0"}:
        raise KeyError(f"unexpected TorchDense parameters {sorted(sub)} under {prefix!r}")
    _dense(state, prefix, sub["Dense_0"])


def _mlp_stack(state: dict, prefix: str, sub: Mapping):
    """An ``MLPStack``: ``TorchDense_{i}`` -> ``{prefix}.layers.{i}``."""
    for layer, leaves in sub.items():
        kind, _, i = layer.rpartition("_")
        if kind != "TorchDense":
            raise KeyError(f"unexpected MLPStack parameter {layer!r} under {prefix!r}")
        _torch_dense(state, f"{prefix}.layers.{i}", leaves)


def zinb_ae_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``ZINBAutoencoder`` tree -> ``ZINBAutoencoder.state_dict()``."""
    state = {}
    for name, sub in params.items():
        if name in ("encoder", "decoder"):
            _mlp_stack(state, name, sub)
        elif name in ("enc_mu", "dec_mean", "dec_disp", "dec_pi"):
            _torch_dense(state, name, sub)
        else:
            raise KeyError(f"unexpected ZINBAutoencoder parameter {name!r}")
    return state


def deepimpute_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A vmapped flax ``_SubNet`` tree (either init) -> the stacked
    ``_SubNet.state_dict()``."""
    names = {f"Dense_{i}" for i in (0, 1)}
    torch_names = {f"TorchDense_{i}" for i in (0, 1)}
    if set(params) == torch_names:
        params = {f"Dense_{i}": params[f"TorchDense_{i}"] for i in (0, 1)}
        if any(set(sub) != {"Dense_0"} for sub in params.values()):
            raise KeyError(f"unexpected _SubNet parameters {sorted(params)}")
        params = {k: sub["Dense_0"] for k, sub in params.items()}
    if set(params) != names or any(set(sub) != {"kernel", "bias"} for sub in params.values()):
        raise KeyError(f"unexpected _SubNet parameters {sorted(params)}")
    return {f"{kind}{i + 1}": _t(params[f"Dense_{i}"][leaf])
            for i in (0, 1) for kind, leaf in (("w", "kernel"), ("b", "bias"))}


def _vae_block(state: dict, prefix: str, sub: Mapping, heads):
    """A VAE block of nn/vae.py: ``MLPStack_0`` -> ``{prefix}.stack``, the
    ``Dense_{k}`` heads -> ``{prefix}.{heads[k]}``."""
    names = {f"Dense_{k}": head for k, head in enumerate(heads)}
    for name, leaves in sub.items():
        if name == "MLPStack_0":
            _mlp_stack(state, f"{prefix}.stack", leaves)
        elif name in names:
            _dense(state, f"{prefix}.{names[name]}", leaves)
        else:
            raise KeyError(f"unexpected parameter {name!r} under {prefix!r}")


_NB, _GAUSS_ENC, _GAUSS_DEC = ("mean", "disp"), ("mu", "logvar"), ("out",)


def _tree(params: Mapping, stacks=(), dense=(), blocks=None) -> Dict[str, torch.Tensor]:
    """Top-level ``MLPStack``s, ``Dense`` layers and VAE blocks by name; raise
    on any other name."""
    state, blocks = {}, blocks or {}
    for name, sub in params.items():
        if name in stacks:
            _mlp_stack(state, name, sub)
        elif name in dense:
            _dense(state, name, sub)
        elif name in blocks:
            _vae_block(state, name, sub, blocks[name])
        else:
            raise KeyError(f"unexpected parameter {name!r}")
    return state


def babel_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``_Babel`` tree -> ``_Babel.state_dict()``."""
    return _tree(params, stacks=("enc1", "enc2", "dec2_stack"), dense=("dec2_out",),
                 blocks={"dec1": _NB})


def cmae_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax CMAE tree -> the port's ``state_dict``: the discriminator's
    ``_Disc`` tree (``Dense_0``, ``Dense_1``) -> ``_Disc``, the generator's
    ``_CMAENet`` tree -> ``_CMAENet``."""
    if set(params) == {"Dense_0", "Dense_1"}:
        state = {}
        _dense(state, "hidden", params["Dense_0"])
        _dense(state, "out", params["Dense_1"])
        return state
    parts = [f"{side}{m}" for side in ("enc", "dec") for m in (1, 2)]
    return _tree(params, stacks=parts, dense=[f"{p}_out" for p in parts])


def mmvae_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``_MMVAENet`` tree -> ``_MMVAENet.state_dict()``."""
    return _tree(params, blocks={"enc1": _GAUSS_ENC, "enc2": _GAUSS_ENC, "dec1": _NB,
                                 "dec2": _GAUSS_DEC})


def scmogcn_v2_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``_ScMoGCNv2Net`` tree -> ``_ScMoGCNv2Net.state_dict()``."""
    state = {}
    for name, sub in params.items():
        kind, _, idx = name.rpartition("_")
        if name == "trunk":
            state.update({f"trunk.{k}": v for k, v in scmogcn_flax_to_torch(sub).items()})
        elif kind == "decoder":
            _dense(state, f"decoder.{idx}", sub)
        elif name in ("c_decoder", "cc_decoder"):
            _dense(state, name, sub)
        else:
            raise KeyError(f"unexpected _ScMoGCNv2Net parameter {name!r}")
    return state


def _dropout_mlp(state: dict, prefix: str, sub: Mapping):
    """A ``DropoutMLP`` (DCCA's and scMVAE's ``_MLP``): ``Dense_{i}`` ->
    ``{prefix}.layers.{i}``."""
    for layer, leaves in sub.items():
        kind, _, i = layer.rpartition("_")
        if kind != "Dense":
            raise KeyError(f"unexpected _MLP parameter {layer!r} under {prefix!r}")
        _dense(state, f"{prefix}.layers.{i}", leaves)


def dcca_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """One flax DCCA ``_ModalityVAE`` tree -> ``_ModalityVAE.state_dict()``
    (call it once for each modality)."""
    state = {}
    for name, sub in params.items():
        if name in ("encoder", "decoder"):
            _dropout_mlp(state, name, sub)
        elif name in ("fc_mean", "fc_logvar", "dec_scale", "dec_disp", "dec_drop"):
            _dense(state, name, sub)
        else:
            raise KeyError(f"unexpected _ModalityVAE parameter {name!r}")
    return state


def jae_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``_JAE`` tree -> ``_JAE.state_dict()``."""
    state = {}
    for name, sub in params.items():
        kind, _, i = name.rpartition("_")
        if kind == "enc_layers":
            _dense(state, f"enc_layers.{i}", sub)
        elif kind == "enc_norms":
            if set(sub) != {"scale", "bias"}:
                raise KeyError(f"unexpected norm parameters {sorted(sub)} under {name!r}")
            state[f"enc_norms.{i}.scale"] = _t(sub["scale"])
            state[f"enc_norms.{i}.bias"] = _t(sub["bias"])
        elif name in ("enc_out", "dec1", "dec2"):
            _dense(state, name, sub)
        else:
            raise KeyError(f"unexpected _JAE parameter {name!r}")
    return state


def scmvae_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``_scMVAENet`` tree -> ``_scMVAENet.state_dict()``: the blocks'
    ``_MLP_0`` -> ``mlp``, their ``Dense_{k}`` heads in call order (``mu``,
    ``logvar`` of a ``_GaussianHead``; ``scale``, ``disp``, ``dropout`` of a
    ``_ZINBDecoder``; ``out`` of a ``_PlainDecoder``), ``share`` a
    ``DropoutMLP``, and the GMM prior's ``pi_logit``, ``mu_c`` and
    ``logvar_c`` as they are."""
    heads = {"enc1": ("mu", "logvar"), "enc2": ("mu", "logvar"), "enc_l1": ("mu", "logvar"),
             "enc_l2": ("mu", "logvar"), "dec1": ("scale", "disp", "dropout")}
    state = {}
    for name, sub in params.items():
        if name in ("pi_logit", "mu_c", "logvar_c"):
            state[name] = _t(sub)
        elif name == "share":
            _dropout_mlp(state, name, sub)
        elif name in heads or name == "dec2":
            names = heads.get(name) or (("scale", "disp", "dropout") if "Dense_2" in sub
                                        else ("out",))
            for block, leaves in sub.items():
                kind, _, k = block.rpartition("_")
                if block == "_MLP_0":
                    _dropout_mlp(state, f"{name}.mlp", leaves)
                elif kind == "Dense" and int(k) < len(names):
                    _dense(state, f"{name}.{names[int(k)]}", leaves)
                else:
                    raise KeyError(f"unexpected parameter {block!r} under {name!r}")
        else:
            raise KeyError(f"unexpected _scMVAENet parameter {name!r}")
    return state


def efnst_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``_EfNSTNet`` tree (EfNST.py:53) -> ``_EfNSTNet.state_dict()``.
    flax numbers the Dense layers as they are built: the decoder's output
    ``Dense_2`` is built before its hidden ``Dense_3``, which it wraps, so
    ``Dense_0, 1, 3, 2`` -> ``denses.0, 1, 2, 3`` (call order)."""
    if set(params) != {f"Dense_{i}" for i in range(4)}:
        raise KeyError(f"unexpected _EfNSTNet parameters {sorted(params)}")
    state = {}
    for i, flax_i in enumerate((0, 1, 3, 2)):
        _dense(state, f"denses.{i}", params[f"Dense_{flax_i}"])
    return state


def scgnn2_feature_ae_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax scGNN2 ``_FeatureAE`` tree (scgnn2.py:40) -> ``_FeatureAE.
    state_dict()``: ``Dense_{i}`` (or ``TorchDense_{i}/Dense_0`` under the
    reference protocol) -> ``layers.{i}``."""
    state = {}
    for name, sub in params.items():
        kind, _, i = name.rpartition("_")
        if kind == "Dense":
            _dense(state, f"layers.{i}", sub)
        elif kind == "TorchDense":
            _torch_dense(state, f"layers.{i}", sub)
        else:
            raise KeyError(f"unexpected _FeatureAE parameter {name!r}")
    return state


def scgnn2_graph_ae_flax_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax scGNN2 ``_GraphAE`` tree (scgnn2.py:68) -> ``_GraphAE.
    state_dict()``: ``Dense_{i}`` -> ``denses.{i}``."""
    state = {}
    for name, sub in params.items():
        kind, _, i = name.rpartition("_")
        if kind != "Dense":
            raise KeyError(f"unexpected _GraphAE parameter {name!r}")
        _dense(state, f"denses.{i}", sub)
    return state


def morphology_flax_to_torch(kernels, dec) -> Dict[str, torch.Tensor]:
    """The JAX morphology encoder's three HWIO kernels and its (128, 3)
    decoder (spatial_feature.py:56-61) -> ``MorphologyEncoder.state_dict()``:
    kernels OIHW."""
    state = {f"kernels.{i}": _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))
             for i, k in enumerate(kernels)}
    state["dec"] = _t(dec)
    return state


__all__ = ["actinn_flax_to_torch", "autoencoder_flax_to_torch", "babel_flax_to_torch",
           "cmae_flax_to_torch", "dcca_flax_to_torch", "deepimpute_flax_to_torch",
           "dstg_flax_to_torch", "efnst_flax_to_torch", "flax_to_torch", "gatconv_flax_to_torch",
           "graphsc_flax_to_torch", "graphsci_flax_to_torch", "jae_flax_to_torch",
           "mmvae_flax_to_torch", "morphology_flax_to_torch", "scdsc_flax_to_torch",
           "scgnn2_feature_ae_flax_to_torch", "scgnn2_graph_ae_flax_to_torch",
           "scheteronet_flax_to_torch", "scmogcn_flax_to_torch", "scmogcn_je_flax_to_torch",
           "scmogcn_match_flax_to_torch", "scmogcn_v2_flax_to_torch", "scmvae_flax_to_torch",
           "sctag_flax_to_torch", "stagate_flax_to_torch", "stdgcn_flax_to_torch",
           "tagconv_flax_to_torch", "zinb_ae_flax_to_torch"]
