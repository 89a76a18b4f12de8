"""Port parity for ACTINN (dance_tpu_torch.modules.single_modality.
cell_type_annotation.actinn), the summary gene filters it stands on
(dance_tpu_torch.transforms.filter) and the staircase learning-rate decay
(``StepLR`` for optax's ``exponential_decay``).

Inputs are made with numpy from a seed and handed to both packages; flax
weights are copied into the torch network (actinn_flax_to_torch, through a
patched ``ACTINN._make_net``) and JAX's batch orders are handed to the port
(through a patched ``epoch_batches_masked``). The gene names are a shuffled
``g{k}``, so that their sorted order, which the JAX filters leave the genes
in, is not the column order. Tolerances: the preprocessing and the filters
exactly (names, order and values); the loss, logits and gradients at rtol
1e-5 (float32 sums in another order), one Adam step at 1e-5; the schedule
over 1,200 steps at 1e-6; a 2-epoch fit's losses at 1e-4 and its weights
within two learning rates a step, all but 0.1 % at rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

from dance_tpu.data import AnnData, Data
from dance_tpu.modules.single_modality.cell_type_annotation.actinn import ACTINN as JACTINN
from dance_tpu.nn.mlp import VanillaMLP as JVanillaMLP
from dance_tpu.transforms import FilterGenesPercentile as JPercentile
from dance_tpu.transforms import FilterGenesTopK as JTopK
from dance_tpu.utils.batch import epoch_batches_masked as jepoch_batches_masked
from dance_tpu_torch.modules.single_modality.cell_type_annotation import ACTINN, actinn_preprocess
from dance_tpu_torch.modules.single_modality.cell_type_annotation import actinn as tactinn
from dance_tpu_torch.nn.mlp import VanillaMLP
from dance_tpu_torch.transforms import FilterGenesPercentile, FilterGenesTopK
from dance_tpu_torch.utils.params import actinn_flax_to_torch
from torch_cases import assert_weights, typed_counts

CPU = torch.device("cpu")


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _data(x, names, types=None):
    obs = {"idx": np.arange(x.shape[0])}
    if types is not None:
        obs["cell_type"] = types.astype(str)
    return Data(AnnData(X=x, obs=obs, var=pd.DataFrame({"gidx": np.arange(len(names))},
                                                       index=names)))


@pytest.mark.parametrize("mode", ["sum", "var", "cv", "rv"])
@pytest.mark.parametrize("kind", ["percentile", "top", "bottom"])
def test_gene_filters_match_jax(kind, mode):
    """The kept columns, their names and their order (sorted by name) against
    the JAX transform on a Data container."""
    counts, _, names = typed_counts(seed=1)
    x = np.log1p(counts)
    if kind == "percentile":
        mine, theirs = FilterGenesPercentile(5, 95, mode=mode), JPercentile(5, 95, mode=mode)
    else:
        mine = FilterGenesTopK(20, top=kind == "top", mode=mode)
        theirs = JTopK(20, top=kind == "top", mode=mode)
    data = _data(x.copy(), names)
    theirs(data)
    got_x, got_names = mine(x, names)
    np.testing.assert_array_equal(got_names, np.asarray(data.data.var_names))
    np.testing.assert_array_equal(got_x, data.data.X)
    np.testing.assert_array_equal(mine.summarize(x), data.data.uns["gene_summary"])
    assert list(got_names) == sorted(got_names) and list(got_names) != sorted(
        got_names, key=lambda s: int(s[1:]))


def test_gene_filter_rejects_repeated_names():
    x = np.ones((4, 3), np.float32)
    with pytest.raises(ValueError, match="unique"):
        FilterGenesTopK(2, mode="sum")(x, ["a", "b", "a"])
    with pytest.raises(ValueError, match="mode"):
        FilterGenesTopK(2, mode="max")


@pytest.mark.parametrize("sparse", [False, True])
def test_actinn_preprocess_matches_jax_pipeline(sparse):
    counts, types, names = typed_counts(200, 60, seed=2)
    x = sp.csr_matrix(counts) if sparse else counts
    data = _data(x.copy(), names, types)
    JACTINN.preprocessing_pipeline(log_level="WARNING")(data)
    got_x, got_names = actinn_preprocess(x, names)
    np.testing.assert_array_equal(got_names, np.asarray(data.data.var_names))
    want = data.data.X.toarray() if sp.issparse(data.data.X) else data.data.X
    np.testing.assert_allclose(got_x, want, rtol=1e-6, atol=0)
    assert got_x.shape[1] < 60 and list(got_names) == sorted(got_names)


def _jax_net(x, n_types, hidden=(12, 8, 6), seed=3):
    jm = JACTINN(hidden_dims=hidden, lambd=0.01)
    jm.model = JVanillaMLP(output_dim=n_types, hidden_dims=hidden)
    params = jm.model.init(jax.random.key(seed), jnp.asarray(x[:1]))["params"]
    return jm, params


def test_actinn_loss_gradients_and_adam_step_match_jax():
    counts, types, names = typed_counts(seed=4)
    x, _ = actinn_preprocess(counts, names)
    jm, params = _jax_net(x, 3)
    mask = np.ones(len(types), np.float32)
    mask[-7:] = 0  # a padded batch's tail
    args = (jnp.asarray(x), jnp.asarray(types, jnp.int32), jnp.asarray(mask))
    jloss, jgrads = jax.value_and_grad(jm._loss_fn)(params, *args)
    tx = optax.adam(1e-2)
    upd, _ = tx.update(jgrads, tx.init(params), params)
    jnext = optax.apply_updates(params, upd)

    net = VanillaMLP(x.shape[1], 3, (12, 8, 6))
    net.load_state_dict(actinn_flax_to_torch(_np_tree(params)))
    np.testing.assert_allclose(net(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm.model.apply({"params": params}, args[0])),
                               rtol=1e-5, atol=1e-6)
    loss = tactinn.actinn_loss(net, torch.from_numpy(x), torch.from_numpy(types),
                               torch.from_numpy(mask), 0.01)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    loss.backward()
    want = actinn_flax_to_torch(_np_tree(jgrads))
    scale = max(float(w.abs().max()) for w in want.values())
    for k, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6 * scale,
                                   err_msg=k)
    torch.optim.Adam(net.parameters(), lr=1e-2).step()
    for k, v in actinn_flax_to_torch(_np_tree(jnext)).items():
        np.testing.assert_allclose(net.state_dict()[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_actinn_fit_matches_jax(monkeypatch):
    """2 epochs of batches of 32 over 150 cells (the last batch padded and
    masked) from the same weights and batch orders: the epochs' losses, the
    weights and the predicted probabilities. JAX's side is its fit's epoch
    scan, from the draws its ``fit`` makes (the init key, then the epochs'
    keys)."""
    counts, types, names = typed_counts(150, 48, seed=5)
    x, _ = actinn_preprocess(counts, names)
    onehot = np.eye(3, dtype=np.float32)[types]
    jm = JACTINN(hidden_dims=(12, 8, 6))
    jm.model = JVanillaMLP(output_dim=3, hidden_dims=(12, 8, 6))
    key, init_key = jax.random.split(jax.random.key(7))
    init = jm.model.init(init_key, jnp.asarray(x[:1]))["params"]
    jm._tx = optax.adam(optax.exponential_decay(0.01, 1000, 0.95, staircase=True))
    epoch_keys = jax.random.split(key, 2)
    jm.params, _, jlosses = jm._train_epochs(init, jm._tx.init(init), jnp.asarray(x),
                                             jnp.asarray(types, jnp.int32), epoch_keys, 32)
    batches = iter([tuple(torch.from_numpy(np.array(a)) for a in
                          jepoch_batches_masked(k, x.shape[0], 32)) for k in epoch_keys])
    monkeypatch.setattr(tactinn, "epoch_batches_masked", lambda gen, n, bs: next(batches))
    make = ACTINN._make_net

    def make_from_jax(self, *args):
        net = make(self, *args)
        net.load_state_dict(actinn_flax_to_torch(_np_tree(init)))
        return net

    monkeypatch.setattr(ACTINN, "_make_net", make_from_jax)
    tm = ACTINN(hidden_dims=(12, 8, 6), device="cpu").fit(x, onehot, batch_size=32, lr=0.01,
                                                          num_epochs=2, seed=7)
    np.testing.assert_allclose([h["loss"] for h in tm.history], np.asarray(jlosses), rtol=1e-4)
    want = {k: v.numpy() for k, v in actinn_flax_to_torch(_np_tree(jm.params)).items()}
    assert_weights({k: v.numpy() for k, v in tm.model.state_dict().items()}, want, 0.01, 10)
    np.testing.assert_allclose(tm.predict_proba(x), jm.predict_proba(x), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(tm.predict(x), jm.predict(x))
    assert tm.score(x, types) == float((tm.predict(x) == types).mean())


def test_step_lr_is_optax_staircase_exponential_decay():
    """``StepLR(opt, 1000, 0.95)`` stepped once per optimizer step gives
    optax's staircase ``exponential_decay(lr, 1000, 0.95)`` as optax reads it
    (at the count before the step), across the decay at step 1,000: the
    learning rates and an SGD trajectory at 1e-6; and with Adam, the way
    ACTINN uses it, at 1e-5 of the largest weight (Adam's own float32 gap
    between torch and optax; a schedule read one step off would be ~1e-4)."""
    rng = np.random.default_rng(8)
    p0 = rng.standard_normal((6, 4)).astype(np.float32)
    grads = rng.standard_normal((1200, 6, 4)).astype(np.float32)
    schedule = optax.exponential_decay(0.01, 1000, 0.95, staircase=True)
    for jtx, make in ((optax.sgd(schedule), torch.optim.SGD),
                      (optax.adam(schedule), torch.optim.Adam)):
        p, state = jnp.asarray(p0), jtx.init(jnp.asarray(p0))
        update = jax.jit(jtx.update)
        tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt = make([tp], lr=0.01)
        sched = torch.optim.lr_scheduler.StepLR(opt, step_size=1000, gamma=0.95)
        gaps, lrs = [], []
        for t, g in enumerate(grads):
            lrs.append((sched.get_last_lr()[0], float(schedule(t))))
            u, state = update(jnp.asarray(g), state, p)
            p = optax.apply_updates(p, u)
            tp.grad = torch.from_numpy(g.copy())
            opt.step()
            sched.step()
            gaps.append(float(np.abs(tp.detach().numpy() - np.asarray(p)).max()))
        lrs = np.asarray(lrs)
        np.testing.assert_allclose(lrs[:, 0], lrs[:, 1], rtol=1e-6)
        assert lrs[999, 0] == 0.01 and abs(lrs[1000, 0] - 0.0095) < 1e-9
        bound = 1e-6 if make is torch.optim.SGD else 1e-5
        assert max(gaps) <= bound * float(np.abs(np.asarray(p)).max()), (make, max(gaps))


def test_actinn_defaults_need_the_card():
    m = ACTINN(device="cpu")
    assert (m.hidden_dims, m.lambd) == ((100, 50, 25), 0.01)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ACTINN()
