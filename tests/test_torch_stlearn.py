"""Port parity for stLearn (dance_tpu_torch.modules.spatial.spatial_domain.
stlearn): the morphology CNN (transforms.spatial_feature), the SME graph
and feature, StKmeans and StLouvain, and the SME front against the JAX
Compose.

Inputs are made with numpy from a seed (``torch_cases.spatial_slide``: 48
spots on an 8 x 6 grid, 40 genes, an H&E-like image; 36 spots on 6 x 6 for
the front). The port's encoder is handed JAX's kernel and decoder
draws (``_jax_encoder``), and its k-means JAX's k-means++ starts
(``_jax_starts``). Tolerances: the convolutions, loss and gradients at 1e-5
of the largest value; the features after 30 Adam epochs and the PCA at 1e-4
of the largest value; the SME graph at 1e-10 (float64) and the SME feature
at 1e-4 of the largest value (a float32 standardisation and PCA, whose
rounding reaches ~1e-4 on some inputs); k-means and Louvain labels
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dance_tpu.data import AnnData, Data
from dance_tpu.modules.spatial.spatial_domain import stlearn as J
from dance_tpu.ops import cluster as jcluster
from dance_tpu.transforms import MorphologyFeatureCNN, SMEFeature
from dance_tpu.transforms.graph import SMEGraph
from dance_tpu_torch.modules.spatial.spatial_domain import stlearn as T
from dance_tpu_torch.ops import cluster as tcluster
from dance_tpu_torch.transforms import spatial_feature as S
from dance_tpu_torch.transforms.graph import spatial_graph as G
from dance_tpu_torch.utils.params import morphology_flax_to_torch
from torch_cases import spatial_slide

CPU = torch.device("cpu")


def _jax_weights(random_state=0):
    """JAX's kernels and decoder draws (spatial_feature.py:56-61, 51-52)."""
    key = jax.random.key(random_state)
    chans = [3, 32, 64, 128]
    kernels = [jax.random.normal(k, (3, 3, chans[i], chans[i + 1]), jnp.float32)
               * np.sqrt(2.0 / (9 * chans[i])) for i, k in enumerate(jax.random.split(key, 3))]
    dec = jax.random.normal(jax.random.fold_in(key, 9), (128, 3), jnp.float32) * 0.05
    return kernels, dec


def _jax_encoder(monkeypatch):
    def init(random_state):
        enc = S.MorphologyEncoder()
        enc.load_state_dict(morphology_flax_to_torch(*_jax_weights(random_state)))
        return enc
    monkeypatch.setattr(S, "morphology_init", init)


def _jax_starts(monkeypatch, seed):
    """The port's k-means++ starts replaced by JAX's (restart i: key(seed + i))."""
    def init(x, n_clusters, generator):
        key = jax.random.key(generator.initial_seed())
        return torch.from_numpy(np.array(jcluster._kmeans_pp_init(jnp.asarray(x.numpy()), key,
                                                                  n_clusters)))
    monkeypatch.setattr(tcluster, "_kmeans_pp_init", init)


def _data(counts, xy, xy_pixel, image):
    adata = AnnData(counts.copy(), var={"gid": np.arange(counts.shape[1])})
    adata.obsm["spatial"] = xy
    adata.obsm["spatial_pixel"] = xy_pixel
    adata.uns["image"] = image
    return Data(adata, train_size="all")


def _close(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def test_encoder_step_matches_jax():
    """Forward, loss and gradients of one training step; the SAME padding
    (0, 1) at stride 2, where ``padding=1`` shifts every output."""
    counts, xy, xy_pixel, image, _ = spatial_slide()
    tiles = np.stack([S.crop_tile(image, x, y, 20, 64) for x, y in xy_pixel[:6]]).astype(
        np.float32)
    kernels, dec = _jax_weights(3)

    def encode(ks, x):
        for w in ks:
            x = jax.nn.relu(jax.lax.conv_general_dilated(x, w, (2, 2), "SAME",
                                                         dimension_numbers=("NHWC", "HWIO",
                                                                            "NHWC")))
        return x

    tgt = tiles.reshape(6, 8, 8, 8, 8, 3).mean((2, 4))

    def jloss(p):
        return jnp.mean((encode(p["kernels"], tiles) @ p["dec"] - tgt) ** 2)

    jl, jg = jax.jit(jax.value_and_grad(jloss))({"kernels": kernels, "dec": dec})
    jfeat, first = jax.jit(lambda ks: (encode(ks, tiles), encode(ks[:1], tiles)))(kernels)
    enc = S.MorphologyEncoder()
    enc.load_state_dict(morphology_flax_to_torch(kernels, dec))
    x = torch.from_numpy(tiles).permute(0, 3, 1, 2)
    feat = enc(x)
    _close(feat.permute(0, 2, 3, 1).detach().numpy(), np.asarray(jfeat), 1e-5)
    loss = torch.mean((enc.reconstruct(x) - torch.from_numpy(tgt)) ** 2)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = morphology_flax_to_torch(jg["kernels"], jg["dec"])
    for name, p in enc.named_parameters():
        _close(p.grad.numpy(), want[name].numpy(), 1e-5)
    w0 = torch.from_numpy(np.transpose(np.asarray(kernels[0]), (3, 2, 0, 1)))
    assert S.same_pad(x).shape[-2:] == (65, 65)
    shifted = F.conv2d(x, w0, stride=2, padding=1).permute(0, 2, 3, 1).numpy()
    first = np.asarray(first)
    assert np.abs(np.maximum(shifted, 0) - first).max() > 0.1 * np.abs(first).max()


def test_sme_graph_and_feature_match_jax():
    """From the same morphology and PCA features: the graph (negative
    correlations kept) and the SME feature with and without its PCA; the
    untrained encoder's raw features."""
    counts, xy, xy_pixel, image, _ = spatial_slide(n_rows=8, n_cols=6)
    data = _data(counts, xy, xy_pixel, image)
    x = np.log1p(counts).astype(np.float32)
    rng = np.random.default_rng(1)
    morph, pcs = (rng.standard_normal((48, 10)).astype(np.float32) for _ in range(2))
    data.data.obsm["MorphologyFeatureCNN"] = morph
    data.data.obsm["CellPCA"] = pcs
    data.data.X = x
    SMEGraph()(data)
    adj = G.sme_graph(xy, xy_pixel, morph, pcs, device=CPU)
    np.testing.assert_allclose(adj, data.data.obsp["SMEGraph"], rtol=1e-10, atol=1e-12)
    assert (adj > 0).sum(1).min() >= 1 and (adj < 0).any()
    SMEFeature(n_components=8)(data)
    _close(S.sme_feature(x, adj, n_components=8, device=CPU), data.data.obsm["SMEFeature"],
           1e-4)
    SMEFeature(n_components=0, out="raw")(data)
    np.testing.assert_allclose(S.sme_feature(x, adj, n_components=0, device=CPU),
                               data.data.obsm["raw"], rtol=1e-12)
    raw = S.morphology_feature_cnn(xy_pixel[:8], image, n_components=0, train_epochs=0,
                                   device=CPU)
    assert raw.shape == (8, 128) and (raw >= 0).all()


def test_heads_and_front_match_jax(monkeypatch):
    counts, xy, xy_pixel, image, _ = spatial_slide(n_rows=6, n_cols=6, g=30, seed=4)
    _jax_encoder(monkeypatch)
    data = _data(counts, xy, xy_pixel, image)
    J._sme_pipeline(n_components=10, log_level="WARNING")(data)
    inp = T.sme_preprocess(counts, xy, xy_pixel, image, n_components=10, device=CPU)
    feat = np.asarray(data.data.obsm["SMEFeature"])
    assert list(inp.genes) == list(data.data.var["gid"])
    np.testing.assert_allclose(inp.x, data.data.X, rtol=1e-5, atol=1e-6)
    # the morphology CNN's 30 Adam epochs on the tiles, then its PCA
    _close(inp.morph, data.data.obsm["MorphologyFeatureCNN"], 1e-4)
    _close(inp.feature, feat, 1e-4)
    # the heads on the same features: k-means from JAX's starts, to the tol stop
    _jax_starts(monkeypatch, 0)
    for k in (3, 5):
        jm = J.StKmeans(n_clusters=k).fit(feat)
        tm = T.StKmeans(n_clusters=k, device=CPU).fit(feat)
        np.testing.assert_array_equal(tm.predict(), jm.predict())
    jl = J.StLouvain(resolution=0.8).fit(feat)
    tl = T.StLouvain(resolution=0.8).fit(feat)
    np.testing.assert_array_equal(tl.predict(), jl.predict())


def test_device_defaults(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.StKmeans()
    xy = np.arange(6.0).reshape(3, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        G.sme_graph(xy, xy, np.ones((3, 2)), np.ones((3, 2)))
    with pytest.raises(ValueError, match="Unsupported model"):
        S.morphology_feature_cnn(np.zeros((1, 2)), np.zeros((4, 4, 3)), model_name="x",
                                 device=CPU)
