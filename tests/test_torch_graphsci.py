"""Port parity for GraphSCI (dance_tpu_torch.modules.single_modality.
imputation.graphsci) and the imputation front it brings: the entry masks,
the gene-gene graph with the RBF affinity and the symmetric normalisation,
the preprocessing, the network's forward, gradients and one AdamW step with
JAX's noise, the loss term by term, 3-epoch fits from the same weights and
noise, a whole fit against JAX's own spread, the format rule and the device
defaults.

Inputs are made with numpy from a seed and handed to both packages; flax
weights are copied into the torch net (graphsci_flax_to_torch, through a
patched ``GraphSCI._make_net``) and JAX's standard normals for ``z_adj``
(``jax.random.split`` of the keys the JAX module uses) are handed to the
port (through a patched ``GraphSCI._noise``), with dropout off where values
are held to each other. Tolerances: masks, graph patterns and the
preprocessing exactly, graph weights at 1e-6; forwards and losses at rtol
1e-5, gradients at 1e-5 of their largest entry, the AdamW step and fits at
rtol 1e-4 / atol 1e-5 (float32 sums in another order); the encoder's biases
before its full-batch norms, whose gradient is zero in exact arithmetic, at
1e-6 of the largest gradient and within two learning rates a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch

from dance_tpu.data import AnnData, Data
from dance_tpu.graph import Graph as JGraph
from dance_tpu.modules.single_modality.imputation import graphsci as J
from dance_tpu.ops.sparse import DenseAdj as JDenseAdj
from dance_tpu.ops.sparse import csr_from_scipy as jcsr
from dance_tpu.transforms import CellwiseMaskData as JMask
from dance_tpu.transforms.filter import _get_count
from dance_tpu.transforms.graph import FeatureFeatureGraph
from dance_tpu.transforms.graph import feature_feature_graph as jffg
from dance_tpu.utils.matrix import dist_to_rbf as jrbf
from dance_tpu_torch.graph import Graph
from dance_tpu_torch.modules.single_modality.imputation import (GraphSCI, graphsci_preprocess)
from dance_tpu_torch.modules.single_modality.imputation import graphsci as T
from dance_tpu_torch.ops.sparse import CSRMatrix, DenseAdj, csr_from_scipy, dense_adj_from_scipy
from dance_tpu_torch.transforms import CellwiseMaskData, feature_feature_graph, get_count
from dance_tpu_torch.utils.matrix import dist_to_rbf
from dance_tpu_torch.utils.params import graphsci_flax_to_torch

CPU = torch.device("cpu")


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _counts(n=150, g=40, seed=0):
    """Poisson counts of cells in three types sharing gene programs, so that
    genes correlate."""
    rng = np.random.default_rng(seed)
    types = rng.integers(0, 3, n)
    programs = rng.gamma(1.0, 1.0, (3, g)) * (rng.random((3, g)) < 0.5)
    rates = (programs[types] + 0.3) * rng.gamma(4.0, 0.25, (n, 1))
    return rng.poisson(rates).astype(np.float32)


def _jax_noise(keys, n):
    """The standard normals JAX's ``_GraphSCINet`` draws for ``z_adj`` under
    each step key: ``normal(split(key, 3)[0])``."""
    return [torch.tensor(np.asarray(jax.random.normal(jax.random.split(k, 3)[0], (n, n))))
            for k in keys]


def _inputs(seed=1, n=120, g=30):
    counts = _counts(n, g, seed)
    x = np.log1p(counts).astype(np.float32)
    mask = CellwiseMaskData(mask_rate=0.1, seed=seed)(x)[0]
    return x, counts, mask, feature_feature_graph(x, 0.3)


def _load_into(model, state, monkeypatch):
    make = model._make_net

    def made(*args):
        net = make(*args)
        net.load_state_dict(state)
        return net

    monkeypatch.setattr(model, "_make_net", made)


# --------------------------------------------------------------------------
# the front: masks, the gene graph, the preprocessing
# --------------------------------------------------------------------------


@pytest.mark.parametrize("distr,add_test,sparse", [("exp", False, False), ("uniform", False, True),
                                                   ("exp", True, True)])
def test_cellwise_masks_are_jax_bit_for_bit(distr, add_test, sparse):
    x = np.log1p(_counts(90, 50, seed=2))
    x[5, :45] = 0  # a cell with too few positive entries keeps them all
    feat = sp.csr_matrix(x) if sparse else x
    data = Data(AnnData(X=feat))
    JMask(distr=distr, mask_rate=0.2, seed=4, add_test_mask=add_test)(data)
    got = CellwiseMaskData(distr=distr, mask_rate=0.2, seed=4, add_test_mask=add_test)(feat)
    for name, mask in zip(("train_mask", "valid_mask", "test_mask"), got):
        np.testing.assert_array_equal(mask, data.data.layers[name], err_msg=name)
    assert got[0][5].all() and (~got[0]).sum() > 0
    with pytest.raises(ValueError):
        CellwiseMaskData(mask_rate=1.5)


@pytest.mark.parametrize("score_func,positive_only", [("pearson", False), ("pearson", True),
                                                      ("spearman", False), ("rbf", False)])
def test_feature_feature_graph_matches_jax(score_func, positive_only, monkeypatch):
    """JAX's ``"rbf"`` branch writes into the read-only array that
    ``np.asarray`` makes of its JAX result and raises; the JAX transform runs
    here on a writable copy of that same result."""
    monkeypatch.setattr(jffg, "dist_to_rbf", lambda *a, **k: np.array(jrbf(*a, **k)))
    x = np.log1p(_counts(80, 25, seed=3))
    x[:, 7] = 0  # a constant gene: NaN correlations, no edges
    data = Data(AnnData(X=x.copy()))
    kw = {"denom": 0.5} if score_func == "rbf" else None
    FeatureFeatureGraph(threshold=0.3, positive_only=positive_only, score_func=score_func,
                        score_func_kwargs=kw)(data)
    jg = data.data.uns["FeatureFeatureGraph"]
    tg = feature_feature_graph(x, 0.3, positive_only=positive_only, score_func=score_func,
                               score_func_kwargs=kw)
    got, want = sp.csr_matrix(tg.adj), sp.csr_matrix(jg.adj)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tg.ndata["feat"], jg.ndata["feat"])
    assert tg.info == jg.info and got.nnz > x.shape[1]
    with pytest.raises(ValueError, match="score function"):
        feature_feature_graph(x, score_func="cosine")


def test_normalisations_and_counts_match_jax():
    rng = np.random.default_rng(5)
    adj = sp.random(30, 30, density=0.2, random_state=5, format="csr", dtype=np.float32)
    adj[3] = 0
    got, want = Graph(adj).normalize_edges_sym().adj, JGraph(adj).normalize_edges_sym().adj
    assert got.dtype == want.dtype and (got != want).nnz == 0
    d = rng.random((12, 12)) * 3
    np.testing.assert_allclose(dist_to_rbf(d, 2.0), jrbf(d, 2.0), rtol=1e-6, atol=1e-7)
    for value, basis in ((0.1, 57), (0.5, 3), (3, 100), (1.0, 10), (None, 4)):
        assert get_count(value, basis) == _get_count(value, basis)


@pytest.mark.parametrize("sparse", [False, True])
def test_graphsci_preprocess_matches_jax_pipeline(sparse):
    """Against the JAX Compose: the gene filter at a tenth (resolved against
    the gene count), a cell without counts dropped, the raw counts, the log
    features, the three masks bit for bit and the gene graph."""
    counts = _counts(160, 40, seed=6)
    counts[:, 2] = 0
    counts[:150, 3], counts[150:, 3] = 0, 5  # in 10 cells: under 10 % of 160, over 10 % of 40
    counts[9] = 0
    x = sp.csr_matrix(counts) if sparse else counts
    adata = AnnData(X=x.copy(), obs={"idx": np.arange(160)}, var={"gidx": np.arange(40)})
    data = Data(adata)
    J.GraphSCI.preprocessing_pipeline(seed=7, log_level="WARNING")(data)
    inp = graphsci_preprocess(x, seed=7)
    ad = data.data
    np.testing.assert_array_equal(inp.cells, ad.obs["idx"].to_numpy())
    np.testing.assert_array_equal(inp.genes, ad.var["gidx"].to_numpy())
    assert 9 not in inp.cells and 2 not in inp.genes and 3 in inp.genes
    raw = ad.raw.X
    np.testing.assert_array_equal(inp.x_raw, raw.toarray() if sp.issparse(raw) else raw)
    xl = ad.X
    np.testing.assert_array_equal(inp.x, xl.toarray() if sp.issparse(xl) else xl)
    for name in ("train_mask", "valid_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(inp, name), ad.layers[name], err_msg=name)
    jg = ad.uns["FeatureFeatureGraph"]
    assert (inp.graph.adj != jg.adj).nnz == 0
    np.testing.assert_array_equal(inp.graph.ndata["feat"], jg.ndata["feat"])
    off = graphsci_preprocess(x, seed=7, mask=False)
    assert off.train_mask.all() and not off.valid_mask.any()


# --------------------------------------------------------------------------
# the network and the loss
# --------------------------------------------------------------------------


# The encoder's Dense biases feed a full-batch norm, which takes their
# effect out: their gradient is zero in exact arithmetic and rounding noise in
# both packages, and Adam moves a weight by up to its learning rate on noise.
_BEFORE_NORM = ("ae.enc1.bias", "ae.enc2.bias")


def _assert_params(net, want, steps: int, lr: float = 1e-3) -> dict:
    """Every weight within two learning rates a step (Adam moves a weight by
    at most about lr a step, even on a gradient at rounding level), and all
    but 0.1 % of them, the biases before a norm aside, at rtol 1e-4 / atol
    1e-5. Returns the masks of the weights outside that."""
    off, total = {}, 0
    for name, p in net.named_parameters():
        got, ref = p.detach().numpy(), want[name].numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=2 * lr * steps, err_msg=name)
        if name not in _BEFORE_NORM:
            off[name] = np.abs(got - ref) > 1e-5 + 1e-4 * np.abs(ref)
            total += ref.size
    assert sum(int(m.sum()) for m in off.values()) <= 1e-3 * total, off
    return off


def _flax_tree(net, like, grad=False):
    """The torch net's weights (or gradients) as a flax tree shaped as ``like``
    (graphsci_flax_to_torch run backwards)."""
    state = {k: (p.grad if grad else p).detach().numpy() for k, p in net.named_parameters()}
    out = {"gnn": {k: state[f"gnn.{k}"] for k in like["gnn"]}, "ae": {}}
    for k, sub in like["ae"].items():
        if k == "mul_bias":
            out["ae"][k] = state["ae.mul_bias"]
        elif k in ("bn1", "bn2"):
            out["ae"][k] = {leaf: state[f"ae.{k}.{leaf}"] for leaf in sub}
        else:
            out["ae"][k] = {"kernel": state[f"ae.{k}.weight"].T}
            if "bias" in sub:
                out["ae"][k]["bias"] = state[f"ae.{k}.bias"]
    return out


def _jax_setup(x, counts, mask, g, dense=False, dropout=0.0, seed=0):
    n_cells, n_genes = x.shape
    net = J._GraphSCINet(n_genes=n_genes, n_cells=n_cells, dropout=dropout)
    adj = jcsr(g.adj)
    if dense:
        adj = JDenseAdj(jnp.asarray(g.adj.toarray()), jnp.asarray(np.diff(g.adj.indptr),
                                                                   jnp.float32))
    sf = jnp.asarray(counts.sum(1) / np.median(counts.sum(1)), jnp.float32)
    key = jax.random.key(seed)  # as GraphSCI.fit inits
    params = net.init({"params": key}, adj, jnp.asarray(x.T), jnp.asarray(x), sf, key)["params"]
    return net, params, adj, sf


def _loss_args(counts, g, mask):
    target = (g.adj.toarray() > 0).astype(np.float32)
    return counts, target, mask.astype(np.float32)


@pytest.mark.parametrize("fmt", ["csr", "dense"])
def test_graphsci_step_matches_jax(fmt):
    """One forward with JAX's noise, the loss and its terms, the gradients
    and one AdamW step, from the same weights."""
    x, counts, mask, g = _inputs(seed=8)
    jnet, params, jadj, sf = _jax_setup(x, counts, mask, g, dense=fmt == "dense")
    raw, target, m = _loss_args(counts, g, mask)
    key = jax.random.key(3)

    def jloss(p):
        out = jnet.apply({"params": p}, jadj, jnp.asarray(x.T), jnp.asarray(x), sf, key)
        z_adj, z_log_std, z_mean, x_exp, mean, disp, pi = out
        terms = J.graphsci_loss(jnp.asarray(raw), jnp.asarray(target), z_adj, z_log_std, z_mean,
                                mean, disp, pi, sf, jnp.asarray(m), 1.0, 0.5, 1.0, 2.0)
        return terms[-1], (terms, out)

    (_, (want_terms, want_out)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)

    tnet = T._GraphSCINet(x.shape[1], x.shape[0], dropout=0.0)
    tnet.load_state_dict(graphsci_flax_to_torch(_np_tree(params)))
    adj = (dense_adj_from_scipy if fmt == "dense" else csr_from_scipy)(g.adj)
    sft = torch.tensor(np.asarray(sf))
    noise = _jax_noise([key], x.shape[1])[0]
    out = tnet(adj, torch.from_numpy(np.ascontiguousarray(x.T)), torch.from_numpy(x), sft, noise)
    terms = T.graphsci_loss(torch.from_numpy(raw), torch.from_numpy(target), *out[:3], *out[4:],
                            sft, torch.from_numpy(m), 1.0, 0.5, 1.0, 2.0)
    for name, got, want in zip(("z_adj", "z_log_std", "z_mean", "x_exp", "mean", "disp", "pi"),
                               out, want_out):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    for name, got, want in zip(("loss_adj", "loss_exp", "log_lik", "kl", "total"), terms,
                               want_terms):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, err_msg=name)
    opt = torch.optim.AdamW(tnet.parameters(), lr=1e-3, weight_decay=1e-5)
    terms[-1].backward()
    want_grads = graphsci_flax_to_torch(_np_tree(jgrads))
    largest = max(float(np.abs(g.numpy()).max()) for g in want_grads.values())
    for name, p in tnet.named_parameters():
        if name in _BEFORE_NORM:  # zero in exact arithmetic: both sides at rounding level
            assert np.abs(p.grad.numpy()).max() <= 1e-6 * largest, name
            continue
        scale = float(np.abs(want_grads[name].numpy()).max())
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=name)
    # optax's AdamW step on the port's own gradients: a gradient at rounding
    # level (a unit that hardly moves) takes a step of up to lr either way
    tx = optax.adamw(1e-3, weight_decay=1e-5)
    tgrads = jax.tree_util.tree_map(jnp.asarray, _flax_tree(tnet, params, grad=True))
    updates, _ = tx.update(tgrads, tx.init(params), params)
    want_after = graphsci_flax_to_torch(_np_tree(optax.apply_updates(params, updates)))
    opt.step()
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_after[name].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)


def test_graphsci_loss_terms_on_edge_cases_match_jax():
    """Zero counts (the zero-inflation case), a mask of zeros, dispersions
    over two orders of magnitude and a graph row without edges, term by
    term."""
    rng = np.random.default_rng(9)
    n, g = 20, 8
    raw = rng.poisson(1.0, (n, g)).astype(np.float32)
    target = (rng.random((g, g)) < 0.3).astype(np.float32)
    target[2] = 0
    z = [rng.normal(size=(g, g)).astype(np.float32) * s for s in (1.0, 3.0, 1.0)]
    mean = rng.gamma(1.0, 1.0, (n, g)).astype(np.float32)
    disp = np.exp(rng.normal(0, 1.5, (n, g))).astype(np.float32)
    pi = rng.random((n, g)).astype(np.float32)
    sf = rng.gamma(4.0, 0.25, n).astype(np.float32)
    for m in ((rng.random((n, g)) < 0.8).astype(np.float32), np.zeros((n, g), np.float32)):
        args = (raw, target, *z, mean, disp, pi, sf, m)
        want = J.graphsci_loss(*map(jnp.asarray, args), 1.0, 2.0, 0.5, 1.0)
        got = T.graphsci_loss(*map(torch.from_numpy, args), 1.0, 2.0, 0.5, 1.0)
        for a, b in zip(got, want):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-5)


def test_graphsci_flax_to_torch_rejects_unknown_names():
    with pytest.raises(KeyError, match="unexpected"):
        graphsci_flax_to_torch({"gnn": {}, "ae": {}})


# --------------------------------------------------------------------------
# fits
# --------------------------------------------------------------------------


def test_fit_matches_jax(monkeypatch):
    """3 epochs from the same weights and JAX's noise with dropout off,
    then ``predict`` (its noise from ``key(0)``), with and without the mask.
    A MultiplyLayer unit within rounding of its ReLU kink gets a gradient of
    exactly 0 in one package and ~1e-9 in the other, and Adam steps it by
    ~lr/2 in that one only (5e-4 apart in the predictions here): the
    predictions are held at 1e-3 as fitted, and at rtol 1e-4 once the few
    weights outside :func:`_assert_params`' 1e-4 are set to JAX's."""
    x, counts, mask, g = _inputs(seed=10)
    n_cells, n_genes = x.shape
    _, init, _, _ = _jax_setup(x, counts, mask, g, seed=2)
    jm = J.GraphSCI(n_cells, n_genes, n_epochs=3, dropout=0.0, seed=2)
    jm.fit(JGraph(g.adj, ndata=dict(g.ndata)), x, counts, mask=mask)
    keys = jax.random.split(jax.random.fold_in(jax.random.key(2), 23), 3)
    noise = iter(_jax_noise(list(keys) + [jax.random.key(0)] * 3, n_genes))
    tm = GraphSCI(n_cells, n_genes, n_epochs=3, dropout=0.0, seed=2, device="cpu")
    _load_into(tm, graphsci_flax_to_torch(_np_tree(init)), monkeypatch)
    monkeypatch.setattr(tm, "_noise", lambda gen: next(noise))
    tm.fit(g, x, counts, mask=mask)
    assert tm.fmt == "csr" and isinstance(tm._cache[0], CSRMatrix)
    want = graphsci_flax_to_torch(_np_tree(jm.params))
    off = _assert_params(tm.net, want, steps=3)
    np.testing.assert_allclose(tm.predict(), jm.predict(), rtol=0, atol=1e-3)
    imputed = tm.predict(mask=mask)
    np.testing.assert_array_equal(imputed[mask], x[mask])
    with torch.no_grad():
        for name, p in tm.net.named_parameters():
            if name in off:
                p[torch.from_numpy(off[name])] = want[name][torch.from_numpy(off[name])]
    np.testing.assert_allclose(tm.predict(mask=mask), jm.predict(mask=mask), rtol=1e-4,
                               atol=1e-5)
    assert len(tm.history) == 3 and all(np.isfinite(h["loss"]) for h in tm.history)


def _masked_rmse(truth, imputed, valid):
    return float(np.sqrt(((truth - imputed)[valid] ** 2).mean()))


def test_whole_fit_within_jax_spread():
    """At the defaults (dropout 0.1, AdamW), 40 epochs on the preprocessed
    counts: the port's masked RMSE (log space) beats the zero guess and is
    no higher than JAX's highest over two seeds plus 5 % of the zero
    guess's."""
    inp = graphsci_preprocess(_counts(200, 40, seed=11), seed=0)
    n_cells, n_genes = inp.x.shape
    zero = _masked_rmse(inp.x, 0.0, inp.valid_mask)
    runs = {"jax": [], "port": []}
    jm = J.GraphSCI(n_cells, n_genes, n_epochs=40)  # one instance: its compiled epochs are reused
    for seed in (1, 2):
        jm.seed, jm.params = seed, None
        jm.fit(JGraph(inp.graph.adj, ndata=dict(inp.graph.ndata)), inp.x, inp.x_raw,
               mask=inp.train_mask)
        tm = GraphSCI(n_cells, n_genes, n_epochs=40, seed=seed, device="cpu")
        tm.fit(inp.graph, inp.x, inp.x_raw, mask=inp.train_mask)
        for key, m in (("jax", jm), ("port", tm)):
            runs[key].append(_masked_rmse(inp.x, m.predict(mask=inp.train_mask),
                                          inp.valid_mask))
    assert max(runs["port"]) <= max(runs["jax"]) + 0.05 * zero, (runs, zero)
    assert max(runs["port"]) < zero
    score = tm.score(None, inp.x, test_idx=np.arange(10))
    assert np.isfinite(score)


def test_format_rule_dense_or_csr_never_bsr(monkeypatch):
    """Dense where the rule says dense, CSR where it says CSR or BSR (JAX
    treats ``"bsr"`` as CSR), CSR on the CPU; the cache keeps the build for
    the same inputs, and a second fit goes on from the trained weights."""
    x, counts, mask, g = _inputs(seed=12, n=60, g=16)
    m = GraphSCI(*x.shape, n_epochs=1, seed=0, device="cpu")
    m.fit(g, x, counts, mask=mask)
    assert m.fmt == "csr"
    built, net = m._fit_cache, m.net
    m.fit(g, x, counts, mask=mask)
    assert m._fit_cache is built and m.net is net
    for answer, fmt, kind in (("dense", "dense", DenseAdj), ("bsr", "csr", CSRMatrix)):
        monkeypatch.setattr(T, "choose_adj_format", lambda *a, answer=answer, **k: answer)
        m._fit_cache_key = None
        m.fit(g, x, counts)
        assert m.fmt == fmt and isinstance(m._cache[0], kind)
        assert np.isfinite(m.predict()).all()


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GraphSCI(10, 5)
    assert GraphSCI(10, 5, device="cpu").device == CPU
