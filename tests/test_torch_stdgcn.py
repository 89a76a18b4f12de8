"""Port parity for stdGCN (dance_tpu_torch.modules.spatial.cell_type_deconvo.
stdgcn): the full-batch norm, the two-tower network's forward and gradients
on CSR, dense and BSR adjacencies, the KL loss, the clipped Adam step, 3-epoch
fits from the same weights, the BSR forward under the shared RCM order,
early stopping, the autoencoder, the SpMM launches of a fit, the graph
cache and the device defaults.

Inputs are made with numpy from a seed and handed to both packages; flax
weights are copied into the torch net (stdgcn_flax_to_torch, through a
patched ``StdGCN._make_net``), and both fits get the same graphs (JAX's
builder, patched into both: the graph builders are compared in
test_torch_deconvo_graph.py). JAX's fits run its per-step ``jit`` with early
stopping on; its whole-fit scan (``early_stopping_patience=0``) is not run
here, its CPU compile being slow. Tolerances: forwards and gradients at rtol
1e-5 (sums in another order), fits at rtol 1e-4 and atol 1e-5, the BSR
forward against CSR at 1e-4, as tests/modules/test_spatial.py:311.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dance_tpu.modules.spatial.cell_type_deconvo import stdgcn as jstdgcn
from dance_tpu.ops import pallas_kernels as jpk
from dance_tpu.ops.sparse import csr_from_scipy as jcsr_from_scipy
from dance_tpu.ops.sparse import dense_adj_from_scipy as jdense_adj_from_scipy
from dance_tpu_torch.modules.spatial.cell_type_deconvo import StdGCN, stdGCNWrapper
from dance_tpu_torch.modules.spatial.cell_type_deconvo import stdgcn as tstdgcn
from dance_tpu_torch.ops import bsr as tbsr
from dance_tpu_torch.ops.sparse import CSRMatrix, DenseAdj, csr_from_scipy, dense_adj_from_scipy
from dance_tpu_torch.transforms import PseudoMixture
from dance_tpu_torch.utils.optim import best_state, clip_by_global_norm_
from dance_tpu_torch.utils.params import autoencoder_flax_to_torch, stdgcn_flax_to_torch
from torch_cases import deconvo_case

CPU = torch.device("cpu")
N_PSEUDO = 120


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _inputs(seed=0, n_spots=80):
    """[pseudo; real] log features, real coordinates and portions."""
    x_ref, labels, x_spots, _, coords = deconvo_case(seed=seed, n_spots=n_spots)
    mix_x, portions, _ = PseudoMixture(n_pseudo=N_PSEUDO, random_state=seed)(x_ref, labels)
    feat = np.log1p(np.concatenate([mix_x, x_spots])).astype(np.float32)
    y = np.concatenate([portions, np.zeros((n_spots, portions.shape[1]))]).astype(np.float32)
    return feat, coords, y


_GRAPHS = {}


def _graphs(seed=0):
    """JAX's two adjacencies for ``_inputs(seed)`` at small neighbour counts."""
    if seed not in _GRAPHS:
        feat, coords, _ = _inputs(seed)
        _GRAPHS[seed] = jstdgcn.build_stdgcn_adjacencies(feat, coords, N_PSEUDO, inter_k=8,
                                                         intra_exp_k=5, space_k=6)
    return _GRAPHS[seed]


def _formats(adj_exp, adj_sp, fmt):
    if fmt == "bsr":
        perm, _ = tbsr.rcm_reorder(adj_exp + adj_sp)
        perm = np.asarray(perm)
        pick = lambda a: a[perm][:, perm]  # noqa: E731
        return perm, ((jpk.bsr_from_scipy(pick(adj_exp)), jpk.bsr_from_scipy(pick(adj_sp))),
                      (tbsr.bsr_from_scipy(pick(adj_exp)), tbsr.bsr_from_scipy(pick(adj_sp))))
    jmake, tmake = {"csr": (jcsr_from_scipy, csr_from_scipy),
                    "dense": (jdense_adj_from_scipy, dense_adj_from_scipy)}[fmt]
    return None, ((jmake(adj_exp), jmake(adj_sp)), (tmake(adj_exp), tmake(adj_sp)))


def _jax_net(feat, y, nhid=16, c=1, f=1, adjs=None, seed=0):
    net = jstdgcn._ConGCN(nhid=nhid, out_dim=y.shape[1], common_hid_layers_num=c,
                          fcnn_hid_layers_num=f, dropout=0.0)
    if adjs is None:
        adjs = tuple(jcsr_from_scipy(a) for a in _graphs())
    return net, net.init(jax.random.key(seed), *adjs, jnp.asarray(feat))["params"]


def test_full_batch_norm_matches_jax():
    x = np.random.default_rng(1).standard_normal((50, 6)).astype(np.float32) * 3 + 2
    jnorm = jstdgcn._FullBatchNorm()
    params = {"scale": np.linspace(0.5, 2, 6).astype(np.float32),
              "bias": np.linspace(-1, 1, 6).astype(np.float32)}
    want = jnorm.apply({"params": params}, jnp.asarray(x))
    norm = tstdgcn._FullBatchNorm(6)
    norm.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    np.testing.assert_allclose(norm(torch.from_numpy(x)).detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fmt", ["csr", "dense", "bsr"])
@pytest.mark.parametrize("layers", [(1, 1), (2, 0)])
def test_congcn_forward_and_grads_match_jax(fmt, layers):
    feat, _, y = _inputs()
    adj_exp, adj_sp = _graphs()
    perm, (jadjs, tadjs) = _formats(adj_exp, adj_sp, fmt)
    if perm is not None:
        feat, y = feat[perm], y[perm]
    jnet, params = _jax_net(feat, y, c=layers[0], f=layers[1], adjs=jadjs)
    m = jnp.asarray((y.sum(1) > 0).astype(np.float32))

    def jloss(p):
        logp = jnet.apply({"params": p}, *jadjs, jnp.asarray(feat))
        return jstdgcn.StdGCN._kl(logp, jnp.asarray(y), m), logp

    (jl, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    net = tstdgcn._ConGCN(feat.shape[1], 16, y.shape[1], *layers, dropout=0.0)
    net.load_state_dict(stdgcn_flax_to_torch(_np_tree(params), *layers))
    logp = net(*tadjs, torch.from_numpy(feat))
    loss = StdGCN._kl(logp, torch.from_numpy(y), torch.from_numpy(np.array(m)))
    loss.backward()
    np.testing.assert_allclose(logp.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    # the bias of a Dense before a full-batch norm has a zero gradient in exact
    # arithmetic: both sides give rounding noise, held against the largest gradient
    want_grads = stdgcn_flax_to_torch(_np_tree(jgrads), *layers)
    scale = max(float(g.abs().max()) for g in want_grads.values())
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)


def test_stdgcn_flax_to_torch_rejects_unknown_parameters():
    with pytest.raises(KeyError):
        stdgcn_flax_to_torch({"Dense_9": {"kernel": np.zeros((2, 2)), "bias": np.zeros(2)}})


def test_kl_matches_jax():
    rng = np.random.default_rng(2)
    logp = np.log(rng.dirichlet(np.ones(4), 30)).astype(np.float32)
    target = rng.dirichlet(np.ones(4), 30).astype(np.float32)
    target[3] = [0.0, 0.5, 0.5, 0.0]  # zero portions: log clipped at 1e-10, as in JAX
    m = (rng.random(30) < 0.5).astype(np.float32)
    want = jstdgcn.StdGCN._kl(jnp.asarray(logp), jnp.asarray(target), jnp.asarray(m))
    got = StdGCN._kl(torch.from_numpy(logp), torch.from_numpy(target), torch.from_numpy(m))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clipped_adam_step_matches_optax(scale):
    """``clip_by_global_norm`` then Adam, as stdgcn.py:445 chains them."""
    rng = np.random.default_rng(3)
    params = [rng.standard_normal(s).astype(np.float32) for s in ((5, 3), (3,))]
    grads = [rng.standard_normal(p.shape).astype(np.float32) * scale for p in params]
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-2))
    state = tx.init([jnp.asarray(p) for p in params])
    updates, _ = tx.update([jnp.asarray(g) for g in grads], state)
    want = optax.apply_updates([jnp.asarray(p) for p in params], updates)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    for p, g in zip(tp, grads):
        p.grad = torch.from_numpy(g.copy())
    clip_by_global_norm_(tp, 1.0)
    torch.optim.Adam(tp, lr=1e-2).step()
    for p, w in zip(tp, want):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def _share_graphs(monkeypatch, seed=0):
    graphs = _graphs(seed)
    monkeypatch.setattr(jstdgcn, "build_stdgcn_adjacencies", lambda *a, **k: graphs)
    monkeypatch.setattr(tstdgcn, "build_stdgcn_adjacencies", lambda *a, **k: graphs)


def _load_into(model, state, monkeypatch):
    make = model._make_net

    def made(*args):
        net = make(*args)
        net.load_state_dict(state)
        return net

    monkeypatch.setattr(model, "_make_net", made)


def _jax_fit(feat, coords_all, y, fmt, monkeypatch, epochs=3):
    """JAX's fit in ``fmt`` ("csr", "dense" or "bsr"), its per-step losses
    and validation losses recorded."""
    losses, vals = [], []
    step = jstdgcn.StdGCN._step

    def record(self, *args, **kw):
        out = step(self, *args, **kw)
        losses.append(float(out[2]))
        vals.append(float(out[3]))
        return out

    with monkeypatch.context() as mp:
        mp.setattr(jstdgcn.StdGCN, "_step", record)
        mp.setattr(jpk, "choose_adj_format", lambda *a, **k: fmt)
        jm = jstdgcn.StdGCN(hidden=(16,), dropout=0.0, seed=0)
        jm.fit((feat, coords_all), y, max_epochs=epochs, early_stopping_patience=5,
               use_bsr="auto")
    return jm, losses, vals


@pytest.mark.parametrize("use_bsr", [False, True])
def test_fit_matches_jax(use_bsr, monkeypatch):
    """3 epochs with early stopping on (a validation read every epoch), from
    the same weights and graphs, dropout off: the losses and validation
    losses at 1e-4, the predictions within the larger of 1e-4 and 4 times
    the JAX package's own spread between its CSR and dense fits. Adam
    divides each gradient by its running size, so a weight whose gradient is
    at rounding level (~1e-9: the bias of a Dense before a full-batch norm,
    0 in exact arithmetic, or a weight of a nearly constant gene) moves by up
    to the learning rate on rounding noise; where the order of the sums
    differs, as between the two packages or between JAX's own formats, the
    predictions move with it (~1e-4 after 3 epochs). The weights are held at
    1e-4 where their step was set by a gradient above that level."""
    _share_graphs(monkeypatch)
    feat, coords, y = _inputs()
    coords_all = np.concatenate([np.zeros((N_PSEUDO, 2), np.float32), coords])
    jm, losses, vals = _jax_fit(feat, coords_all, y, "bsr" if use_bsr else "csr", monkeypatch)
    spread = np.abs(_jax_fit(feat, coords_all, y, "dense", monkeypatch)[0].predict()
                    - _jax_fit(feat, coords_all, y, "csr", monkeypatch)[0].predict()).max()
    _, init = _jax_net(feat, y)
    init = stdgcn_flax_to_torch(_np_tree(init))
    tm = StdGCN(hidden=(16,), dropout=0.0, seed=0, device="cpu")
    _load_into(tm, init, monkeypatch)
    tm.fit((feat, coords_all), y, max_epochs=3, early_stopping_patience=5, use_bsr=use_bsr)
    assert tm.fmt == ("bsr" if use_bsr else "csr")
    np.testing.assert_allclose([h["loss"] for h in tm.history], losses, rtol=1e-4)
    np.testing.assert_allclose([h["val"] for h in tm.history], np.round(vals, 4), atol=1e-4)
    pred = tm.predict()
    gap = np.abs(pred - jm.predict()).max()
    assert gap <= max(1e-4, 4 * spread), (gap, spread)
    np.testing.assert_allclose(pred.sum(1), 1.0, rtol=1e-5)
    want = stdgcn_flax_to_torch(_np_tree(jm.params))
    for name, p in tm.net.named_parameters():
        w = want[name].numpy()
        held = np.abs(w - init[name].numpy()) > 2.5e-2  # 3 steps of ~lr: gradients above noise
        np.testing.assert_allclose(p.detach().numpy()[held], w[held], rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    if use_bsr:
        np.testing.assert_array_equal(tm._perm, np.asarray(jm._perm))
    assert tm.score(None, y, test_idx=np.arange(N_PSEUDO, len(y))) == pytest.approx(
        jm.score(None, y, test_idx=np.arange(N_PSEUDO, len(y))), rel=1e-3)


def test_bsr_forward_is_permutation_consistent():
    """As tests/modules/test_spatial.py:311 holds the JAX net: the two towers
    on BSR tiles under the shared RCM order give the CSR forward, un-permuted;
    each tiling keeps its own transpose."""
    feat, _, y = _inputs(1)
    adj_exp, adj_sp = tstdgcn.build_stdgcn_adjacencies(feat, _inputs(1)[1], N_PSEUDO,
                                                       inter_k=8, intra_exp_k=5, space_k=6,
                                                       device=CPU)
    net = tstdgcn._ConGCN(feat.shape[1], 16, y.shape[1], dropout=0.0)
    net.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        out_csr = net(csr_from_scipy(adj_exp), csr_from_scipy(adj_sp), torch.from_numpy(feat))
        perm, (_, (b_exp, b_sp)) = _formats(adj_exp, adj_sp, "bsr")
        out_bsr = net(b_exp, b_sp, torch.from_numpy(feat[perm]))
    np.testing.assert_allclose(out_csr.numpy(), tbsr.unpermute(perm, out_bsr.numpy()),
                               atol=1e-4)
    t_exp, t_sp = tbsr.bsr_transpose(b_exp), tbsr.bsr_transpose(b_sp)
    assert t_exp is not t_sp and tbsr.bsr_transpose(b_exp) is t_exp
    for a, t in ((b_exp, t_exp), (b_sp, t_sp)):
        dense = tbsr.bsr_spmm_reference(a, torch.eye(a.shape[1])).numpy()
        np.testing.assert_array_equal(tbsr.bsr_spmm_reference(t, torch.eye(t.shape[1])).numpy(),
                                      dense.T)


def _scripted(monkeypatch, model, vals, snaps):
    """Validation losses from ``vals``: every second call of ``_kl`` is the
    validation read after a step; ``snaps`` gets the weights at each."""
    kl, calls = StdGCN._kl, {"n": 0}

    def scripted(logp, target, m):
        calls["n"] += 1
        if calls["n"] % 2:
            return kl(logp, target, m)
        snaps.append(best_state(model.net))
        return torch.tensor(vals[calls["n"] // 2 - 1])

    monkeypatch.setattr(StdGCN, "_kl", staticmethod(scripted))


def test_early_stopping_keeps_the_best_weights(monkeypatch):
    """Patience 2 counts from 1 after a new best, on values rounded to 4
    places: 0.40004 does not beat 0.4, and the stop comes at epoch 3 with
    epoch 1's weights."""
    feat, coords, y = _inputs(2)
    m = StdGCN(hidden=(8,), dropout=0.0, seed=0, device="cpu")
    snaps = []
    _scripted(monkeypatch, m, [0.5, 0.4, 0.40004, 0.41, 0.3, 0.2], snaps)
    m.fit((feat, coords), y, max_epochs=6, early_stopping_patience=2, inter_k=8,
          intra_exp_k=5, space_k=6)
    assert m.stopped_epoch == 3 and len(m.history) == 4 and len(snaps) == 4
    assert [h["val"] for h in m.history] == [0.5, 0.4, 0.4, 0.41]
    for k, v in m.net.state_dict().items():
        assert torch.equal(v, snaps[1][k]) and not torch.equal(v, snaps[3][k]), k


def test_plain_epochs_keep_the_last_weights_and_count_spmm(monkeypatch):
    """Patience 0: ``max_epochs`` steps, no validation read, the last weights;
    4 tower aggregations forward and 4 ``Aᵀḡ`` an epoch on the BSR tiles, 4
    in ``predict``, and 4 more an epoch for the validation forward."""
    calls = {"spmm": 0}
    spmm = tbsr.bsr_spmm

    def count(*args, **kw):
        calls["spmm"] += 1
        return spmm(*args, **kw)

    monkeypatch.setattr(tbsr, "bsr_spmm", count)
    feat, coords, y = _inputs(3)
    m = StdGCN(hidden=(8,), dropout=0.0, seed=0, device="cpu")
    snaps = []
    m.fit((feat, coords), y, max_epochs=4, early_stopping_patience=0, use_bsr=True,
          inter_k=8, intra_exp_k=5, space_k=6)
    m.predict()
    assert calls["spmm"] == 8 * 4 + 4
    assert len(m.history) == 4 and all(h["val"] is None for h in m.history)
    assert m.stopped_epoch is None
    _scripted(monkeypatch, m, [1.0, 0.9, 0.8], snaps)
    m.fit((feat, coords), y, max_epochs=3, early_stopping_patience=5, use_bsr=True,
          inter_k=8, intra_exp_k=5, space_k=6)
    assert calls["spmm"] == 36 + 12 * 3
    for k, v in m.net.state_dict().items():
        assert torch.equal(v, snaps[-1][k])


def test_graph_cache_and_formats(monkeypatch):
    """A second fit on the same inputs and options builds no graph; another
    format or input builds again; "auto" is CSR on the CPU. The dense route
    gives the CSR fit (within Adam's rounding spread, see
    test_fit_matches_jax); BSR trains on another 90/10 split (the labelled
    spots are split in the RCM order, as in JAX)."""
    builds, builds_kw = [], []
    build = tstdgcn.build_stdgcn_adjacencies
    monkeypatch.setattr(tstdgcn, "build_stdgcn_adjacencies",
                        lambda *a, **k: builds.append(1) or builds_kw.append(k) or build(*a, **k))
    feat, coords, y = _inputs(4)
    m = stdGCNWrapper(hidden=(8,), dropout=0.0, seed=0, device="cpu")
    kw = dict(max_epochs=2, inter_k=8, intra_exp_k=5, space_k=6)
    m.fit((feat, coords), y, **kw)
    assert m.fmt == "csr" and isinstance(m.adj_exp, CSRMatrix) and len(builds) == 1
    first = m.predict()
    m.fit((feat, coords), y, **kw)
    assert len(builds) == 1
    np.testing.assert_array_equal(m.predict(), first)
    m.fit((feat, coords), y, use_bsr=True, **kw)
    assert len(builds) == 2 and isinstance(m.adj_exp, tbsr.BSRMatrix)
    assert m.adj_exp is not m.adj_sp and m.adj_exp.shape == m.adj_sp.shape
    np.testing.assert_allclose(m.predict().sum(1), 1.0, rtol=1e-5)
    m.fit((feat * 1.5, coords), y, use_bsr=True, **kw)
    assert len(builds) == 3
    # ComBat's integration is another graph option: it builds again, and trains
    # (its graphs and fit against JAX's: test_combat_fit_matches_jax)
    m.fit((feat, coords), y, batch_removal_method="combat", use_bsr=True, **kw)
    assert len(builds) == 4 and builds_kw[-1]["integration_batch_removal"] == "combat"
    np.testing.assert_allclose(m.predict().sum(1), 1.0, rtol=1e-5)
    d = StdGCN(hidden=(8,), dropout=0.0, seed=0, device="cpu")
    monkeypatch.setattr(tstdgcn, "resolve_adj_format", lambda *a, **k: "dense")
    d.fit((feat, coords), y, **kw)
    assert isinstance(d.adj_exp, DenseAdj)
    np.testing.assert_allclose(d.predict(), first, atol=1e-3)


def _jax_neighbours(monkeypatch):
    """The port's builders given JAX's kNN and PCA (their float32 answers
    differ at rounding, which can move a kNN tie), as
    tests/test_torch_deconvo_graph.py does, so that ComBat and the assembly
    are what is compared."""
    from dance_tpu.ops import linalg as jlinalg
    from dance_tpu.ops.neighbors import _knn_block
    from dance_tpu_torch.ops.linalg import PCAResult

    def knn(q, x, k, device):
        d, i = _knn_block(np.asarray(q, np.float32), np.asarray(x, np.float32), min(k, len(x)))
        return np.asarray(d), np.asarray(i)

    def pca(x, n, seed=0):
        res = jlinalg.pca(x.cpu().numpy(), n, seed=seed)
        return PCAResult(*(torch.from_numpy(np.array(a)) for a in res))

    monkeypatch.setattr(tstdgcn, "_knn", knn)
    monkeypatch.setattr(tstdgcn, "pca", pca)


def test_combat_fit_matches_jax(monkeypatch):
    """``batch_removal_method="combat"``: each package builds its own graphs
    (ComBat over the pseudo and real blocks, then the PCA integration), which
    agree; then 3 epochs from the same weights, dropout off, early stopping
    on: the losses at 1e-4 and the predictions within the larger of 1e-4
    and 4 times JAX's own spread between its CSR and dense fits, as
    test_fit_matches_jax holds them."""
    _jax_neighbours(monkeypatch)
    feat, coords, y = _inputs(6)
    coords_all = np.concatenate([np.zeros((N_PSEUDO, 2), np.float32), coords])
    kw = dict(inter_k=8, intra_exp_k=5, space_k=6)
    want = jstdgcn.build_stdgcn_adjacencies(feat, coords, N_PSEUDO,
                                            integration_batch_removal="combat", **kw)
    got = tstdgcn.build_stdgcn_adjacencies(feat, coords, N_PSEUDO, device=CPU,
                                           integration_batch_removal="combat", **kw)
    plain = tstdgcn.build_stdgcn_adjacencies(feat, coords, N_PSEUDO, device=CPU, **kw)
    for g, w in zip(got, want):
        w = w if hasattr(w, "toarray") else np.asarray(w)
        np.testing.assert_allclose(g.toarray(), w.toarray() if hasattr(w, "toarray") else w,
                                   rtol=1e-6, atol=1e-7)
    assert (got[0] != plain[0]).nnz > 0  # ComBat moves the real-pseudo links

    def jax_fit(fmt):
        losses = []
        step = jstdgcn.StdGCN._step

        def record(self, *args, **k):
            out = step(self, *args, **k)
            losses.append(float(out[2]))
            return out

        with monkeypatch.context() as mp:
            mp.setattr(jstdgcn.StdGCN, "_step", record)
            mp.setattr(jpk, "choose_adj_format", lambda *a, **k: fmt)
            jm = jstdgcn.StdGCN(hidden=(16,), dropout=0.0, seed=0)
            jm.fit((feat, coords_all), y, max_epochs=3, batch_removal_method="combat", **kw)
        return jm, losses

    jm, losses = jax_fit("csr")
    spread = np.abs(jax_fit("dense")[0].predict() - jm.predict()).max()
    _, init = _jax_net(feat, y, adjs=tuple(jcsr_from_scipy(a) for a in want))
    tm = StdGCN(hidden=(16,), dropout=0.0, seed=0, device="cpu")
    _load_into(tm, stdgcn_flax_to_torch(_np_tree(init)), monkeypatch)
    tm.fit((feat, coords_all), y, max_epochs=3, batch_removal_method="combat", use_bsr=False,
           **kw)
    np.testing.assert_allclose([h["loss"] for h in tm.history], losses, rtol=1e-4)
    gap = np.abs(tm.predict() - jm.predict()).max()
    assert gap <= max(1e-4, 4 * spread), (gap, spread)


def test_autoencoder_and_auto_train_match_jax(monkeypatch):
    x = np.log1p(deconvo_case(seed=5)[0][:60])
    jnet = jstdgcn.autoencoder(x_size=x.shape[1], hidden_size=25, embedding_size=10)
    params = jnet.init(jax.random.key(0), jnp.asarray(x))["params"]
    want_en, want_de = jnet.apply({"params": params}, jnp.asarray(x))
    state = autoencoder_flax_to_torch(_np_tree(params))
    net = tstdgcn.autoencoder(x.shape[1], 25, 10)
    net.load_state_dict(state)
    en, de = net(torch.from_numpy(x))
    np.testing.assert_allclose(en.detach().numpy(), np.asarray(want_en), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(de.detach().numpy(), np.asarray(want_de), rtol=1e-5, atol=1e-5)
    # auto_train: 5 Adam steps from the same weights (flax's hidden width is
    # int((80 + 10) / 2) = 45)
    params = jstdgcn.autoencoder(x_size=x.shape[1], hidden_size=45, embedding_size=10).init(
        jax.random.key(0), jnp.asarray(x))["params"]
    monkeypatch.setattr(tstdgcn.autoencoder, "reset_parameters",
                        lambda self, generator=None: self.load_state_dict(
                            autoencoder_flax_to_torch(_np_tree(params))))
    want = jstdgcn.auto_train(x, epoch_n=5, latent_size=10, seed=0)
    got = tstdgcn.auto_train(x, epoch_n=5, latent_size=10, seed=0, device=CPU)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)
    full = tstdgcn.full_block(4, 3, 0.0)
    assert isinstance(full[1], torch.nn.LayerNorm) and full[1].eps == 1e-6


def test_stdgcn_needs_a_card_unless_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='auto'"):
        StdGCN()
    assert StdGCN(device="cpu").device == CPU
    assert tstdgcn.conGCN is tstdgcn._ConGCN
