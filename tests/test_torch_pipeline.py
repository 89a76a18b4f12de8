"""The DANCE 2.0 search path of the port (dance_tpu_torch.pipeline) against
the JAX package's (dance_tpu.pipeline), and the nine transforms the tuning
configs name that the port registers for it.

- The planer on the real tuning configs: every
  ``examples/tuning/*/pipeline_params_tuning_config.yaml`` but
  ``custom-methods`` (which registers its own transform), loaded with
  ``yaml.safe_load`` here: equal ``search_space()``, equal
  ``generate_config`` for the first 5 trials of a seeded ``SweepRunner``,
  and every target resolving in the port's registry.
- The sweep runner: grid, random, integer-range and log-uniform trial
  sequences equal; the summary CSVs parse to equal tables; ``best`` the
  same record; the step-3 JSON files equal JAX's YAML content, and so do
  the subset files; a resumed grid over ``target_sum: [1000, 10000, null]``
  reruns 6 of 6 finished trials in JAX and 0 in the port.
- ``run_vmapped`` on a tiny MLP from the same numpy weights in every trial:
  scores within 1e-5 and final losses within 1e-4, relative.
- The nine container calls against JAX's on the same ``Data``: exact, but
  ``ColumnSumNormalize`` (float32 sums in another order) and ``CellSVD``
  (another SVD) within 1e-6 of the largest value; and the ``mod`` option
  the joint-embedding configs set.
"""

import glob
import json
import os

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch
import yaml

import dance_tpu.datasets.synthetic as jsyn
import dance_tpu.pipeline as J
import dance_tpu.transforms as JT
import dance_tpu_torch.pipeline as T
import dance_tpu_torch.transforms as TT
from dance_tpu.registry import REGISTRY as JREG
from dance_tpu_torch.datasets import synthetic as tsyn
from dance_tpu_torch.registry import REGISTRY as TREG

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(p for p in glob.glob(os.path.join(
    REPO, "examples", "tuning", "*", "pipeline_params_tuning_config.yaml"))
    if "custom-methods" not in p)


def _trial_kwargs(planer, trial):
    return {"params": trial} if planer.tune_mode == "params" else {"pipeline": trial}


def test_thirty_configs():
    assert len(CONFIGS) == 30


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.split(os.sep)[-2])
def test_planer_on_tuning_config(path):
    with open(path) as f:
        cfg = yaml.safe_load(f)
    jp, tp = J.PipelinePlaner(cfg), T.PipelinePlaner(cfg)
    assert tp.search_space() == jp.search_space()
    assert (tp.tune_mode, tp.pipeline_tuning_top_k, tp.parameter_tuning_freq_n) == \
        (jp.tune_mode, jp.pipeline_tuning_top_k, jp.parameter_tuning_freq_n)
    for elem in cfg["pipeline"]:
        scope = f"preprocessor.{elem['type']}"
        for name in elem.get("include", []) + ([elem["target"]] if "target" in elem else []):
            assert TREG.get(f"{scope}.{name}") is not None, f"{scope}.{name}"
    jr = J.SweepRunner(jp.search_space(), seed=0)
    tr = T.SweepRunner(tp.search_space(), seed=0)
    trials = list(tr._trial_configs(5))
    assert trials == list(jr._trial_configs(5))
    for trial in trials:
        got = tp.generate_config(**_trial_kwargs(tp, trial))
        assert got.to_dict() == jp.generate_config(**_trial_kwargs(jp, trial)).to_dict()
        pipe = T.Pipeline(got)
        for step in pipe:  # every active step resolves and constructs
            assert TREG.get(f"{step.scope.replace('_registry_.', '')}.{step.target}") is not None
            step.functional


SPACES = {
    "grid": ({"a": {"values": [1, 2, 3]}, "b": {"values": ["x", None]}}, "grid"),
    "random": ({"a": {"values": [1000, 10000, None]}, "b": {"values": ["p", "q", "r"]}},
               "random"),
    "int_range": ({"n": {"min": 2, "max": 40}, "u": {"min": 0.1, "max": 0.9}}, "random"),
    "log_uniform": ({"lr": {"min": 1e-4, "max": 1e-1, "distribution": "log_uniform_values"},
                     "k": {"values": [3, 5]}}, "random"),
}


@pytest.mark.parametrize("case", sorted(SPACES))
def test_trial_sequences(case):
    space, method = SPACES[case]
    for seed in (0, 7):
        jr = J.SweepRunner(space, method=method, seed=seed)
        tr = T.SweepRunner(space, method=method, seed=seed)
        assert list(tr._trial_configs(8)) == list(jr._trial_configs(8))


def _metrics(cfg):
    """A deterministic trial: a score from the config, and an error on one
    config, which the runner records and passes."""
    if cfg.get("b") == "r" and cfg.get("a") == 10000:
        raise RuntimeError("bad trial")
    a = cfg.get("a") or 1
    return {"acc": 1.0 / a + 0.01 * len(str(cfg.get("b"))), "n": a}


def _drop_runtime(table: pd.DataFrame) -> pd.DataFrame:
    return table.drop(columns=["_runtime"])


def test_summary_best_and_step3(tmp_path):
    space = {"pipeline.0.filter.gene": {"values": ["FilterGenesPercentile", "_skip_"]},
             "pipeline.1.normalize": {"values": ["NormalizeTotal", "Log1P",
                                                 "NormalizePlaceHolder"]}}
    cfg = {"type": "preprocessor", "tune_mode": "pipeline_params", "wandb": {"project": "p"},
           "pipeline": [{"type": "filter.gene",
                         "include": ["FilterGenesPercentile", "FilterGenesPlaceHolder"],
                         "skippable": True,
                         "default_params": {"FilterGenesPercentile": {"min_val": 2}}},
                        {"type": "normalize", "include": ["NormalizeTotal", "Log1P",
                                                          "NormalizePlaceHolder"],
                         "params_to_tune": {"NormalizeTotal": {
                             "target_sum": {"values": [1000, 10000, None]}}}}]}
    jp, tp = J.PipelinePlaner(cfg), T.PipelinePlaner(cfg)
    assert tp.search_space() == jp.search_space()
    assert sorted(tp.search_space()) == sorted(space)

    def score(c):
        return {"test_acc": len(c["pipeline.1.normalize"]) / 10
                + (0.5 if c["pipeline.0.filter.gene"] == "_skip_" else 0.0)}

    jcsv, tcsv = str(tmp_path / "j" / "summary.csv"), str(tmp_path / "t" / "summary.csv")
    jr = jp.sweep_agent(score, count=6, method="grid", summary_file_path=jcsv)
    tr = tp.sweep_agent(score, count=6, method="grid", summary_file_path=tcsv)
    pd.testing.assert_frame_equal(_drop_runtime(pd.read_csv(tcsv)),
                                  _drop_runtime(pd.read_csv(jcsv)))
    strip = lambda r: {k: v for k, v in r.items() if k != "_runtime"}  # noqa: E731
    assert strip(tr.best("test_acc")) == strip(jr.best("test_acc"))
    assert strip(tr.best("test_acc", maximize=False)) == strip(jr.best("test_acc",
                                                                       maximize=False))

    # the step-3 configs from either summary: JSON from the port, YAML from JAX
    req = dict(required_funs=["SetConfig"], required_indexes=[100],
               required_params=[{"config_dict": {"label_channel": "cell_type"}}])
    for src in (jcsv, tcsv):
        jpaths = J.get_step3_yaml(src, jp, conf_save_path=str(tmp_path / "j3"), top_k=2, **req)
        tpaths = T.get_step3_yaml(src, tp, conf_save_path=str(tmp_path / "t3"), top_k=2, **req)
        assert [os.path.basename(p) for p in tpaths] == ["0_params_tuning_config.json",
                                                         "1_params_tuning_config.json"]
        for jpath, tpath in zip(jpaths, tpaths):
            with open(jpath) as fj, open(tpath) as ft:
                assert json.load(ft) == yaml.safe_load(fj)

    # step 3 on the port's files: one runner a config, its summary beside
    runners = T.run_step3(str(tmp_path / "t3"), lambda planer, c: {"test_acc": 1.0}, count=2,
                          result_dir=str(tmp_path / "res"))
    assert len(runners) == 2 and all(len(r.records) == 2 for r in runners)
    assert sorted(os.listdir(tmp_path / "res")) == ["0_params_tuning_config.json.csv",
                                                    "1_params_tuning_config.json.csv"]


def test_summary_table_with_gaps_and_errors(tmp_path):
    space = SPACES["random"][0]
    jr = J.SweepRunner(space, seed=3).run(_metrics, count=12)
    tr = T.SweepRunner(space, seed=3).run(_metrics, count=12)
    assert any("error" in r for r in tr.records)
    jcsv, tcsv = tmp_path / "j.csv", tmp_path / "t.csv"
    jr.summary().to_csv(jcsv, index=False)
    tr.write_summary(str(tcsv))
    want = _drop_runtime(pd.read_csv(jcsv))
    pd.testing.assert_frame_equal(_drop_runtime(pd.read_csv(tcsv)), want)
    # the in-memory table: JAX's columns, dtypes and gaps
    frame, jframe = tr.summary(), _drop_runtime(jr.summary())
    assert frame.columns == list(jr.summary().columns)
    for col in jframe.columns:
        got, exp = frame[col], jframe[col].to_numpy()
        if exp.dtype.kind == "f":
            np.testing.assert_array_equal(got, exp)
        else:
            assert [None if (isinstance(v, float) and np.isnan(v)) else v for v in exp] == \
                [None if (isinstance(v, float) and np.isnan(v)) else v for v in got], col
    # the port's reader on JAX's file and on its own
    for path in (jcsv, tcsv):
        loaded = T.read_records_csv(str(path))
        assert [r["acc"] for r in loaded] == pytest.approx(
            [None if np.isnan(v) else v for v in want["acc"]], nan_ok=True)


def test_resume_reruns(tmp_path):
    """JAX compares a resumed trial by ``str(value)`` against pandas' reading
    of the summary (1000 -> 1000.0, None -> nan): all 6 finished trials of the
    grid run again. The port compares values: none does."""
    space = {"params.0.FilterGenesPercentile.min_val": {"values": [1, 2]},
             "params.1.NormalizeTotal.target_sum": {"values": [1000, 10000, None]}}
    cfg = {"type": "preprocessor", "tune_mode": "params",
           "pipeline": [{"type": "filter.gene", "target": "FilterGenesPercentile",
                         "params_to_tune": {"min_val": space[
                             "params.0.FilterGenesPercentile.min_val"]}},
                        {"type": "normalize", "target": "NormalizeTotal",
                         "params_to_tune": {"target_sum": space[
                             "params.1.NormalizeTotal.target_sum"]}}]}
    reruns = {}
    for name, mod in (("jax", J), ("port", T)):
        planer = mod.PipelinePlaner(cfg)
        assert planer.search_space() == space
        path = str(tmp_path / name / "summary.csv")
        calls = []
        planer.sweep_agent(lambda c: calls.append(c) or {"test_acc": 0.5}, method="grid",
                           summary_file_path=path)
        assert len(calls) == 6
        calls.clear()
        runner = planer.sweep_agent(lambda c: calls.append(c) or {"test_acc": 0.5},
                                    method="grid", summary_file_path=path, resume=True)
        reruns[name] = len(calls)
        assert len(runner.records) == 6 + len(calls)
    assert reruns == {"jax": 6, "port": 0}


def test_generate_subsets(tmp_path):
    cfg = {"type": "preprocessor", "tune_mode": "pipeline",
           "pipeline": [{"type": "filter.gene", "include": ["FilterGenesPercentile"]},
                        {"type": "normalize", "include": ["Log1P"]},
                        {"type": "misc", "target": "SetConfig",
                         "params": {"config_dict": {"label_channel": "cell_type"}}}]}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    jpaths = J.generate_subsets(str(path), str(tmp_path / "j"), required_indexes=[2],
                                launch_script_path=str(tmp_path / "j.sh"))
    tpaths = T.generate_subsets(str(path), str(tmp_path / "t"), required_indexes=[2],
                                launch_script_path=str(tmp_path / "t.sh"))
    assert len(tpaths) == len(jpaths) == 4
    for jpath, tpath in zip(jpaths, tpaths):
        assert tpath.endswith(".json")
        with open(jpath) as fj, open(tpath) as ft:
            assert json.load(ft) == yaml.safe_load(fj)
    assert (tmp_path / "t.sh").read_text() == (tmp_path / "j.sh").read_text().replace(
        str(tmp_path / "j"), str(tmp_path / "t")).replace(".yaml", ".json")
    assert T.flatten_dict({"a": {"x": 1, "y": {"z": 2}}, "b": 3}) == \
        J.flatten_dict({"a": {"x": 1, "y": {"z": 2}}, "b": 3})


def test_yaml_and_wandb_refused(tmp_path):
    with pytest.raises(NotImplementedError, match="PyYAML"):
        T.PipelinePlaner.from_config_file(CONFIGS[0])
    planer = T.PipelinePlaner({"type": "preprocessor", "tune_mode": "pipeline",
                               "pipeline": [{"type": "normalize", "include": ["Log1P"]}]})
    for call in (planer.wandb_sweep, lambda: planer.wandb_sweep_agent(print),
                 lambda: T.save_summary_data(summary_file_path=str(tmp_path / "s.csv")),
                 lambda: T.get_additional_sweep("e", "p", "s")):
        with pytest.raises(NotImplementedError, match="wandb"):
            call()
    with pytest.raises(KeyError, match="JAX package"):
        T.Action(type_="normalize", target="Log1P", scope="dance_tpu.transforms").functional


# --------------------------------------------------------------------------
# run_vmapped
# --------------------------------------------------------------------------

def _mlp_case(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((64, 6)).astype(np.float32)
    y = (x[:, :3].sum(1) > 0).astype(np.int64)
    w = {"w1": rng.standard_normal((6, 8)).astype(np.float32) * 0.5,
         "b1": np.zeros(8, np.float32),
         "w2": rng.standard_normal((8, 2)).astype(np.float32) * 0.5,
         "b2": np.zeros(2, np.float32)}
    return x, y, w


def _jax_trial(x, y, w, with_score):
    import jax
    import jax.numpy as jnp

    def make_trial(configs):
        def init_fn(key):
            return {k: jnp.asarray(v) for k, v in w.items()}

        def nll(p, bx, by):
            h = jnp.tanh(bx @ p["w1"] + p["b1"])
            logp = jax.nn.log_softmax(h @ p["w2"] + p["b2"], -1)
            return -jnp.take_along_axis(logp, by[:, None], 1).mean()

        def loss_fn(p, batch, hyper):
            l2 = sum((v ** 2).sum() for v in jax.tree_util.tree_leaves(p))
            return nll(p, *batch) + hyper["lambd"] * l2

        score = (lambda p, batch: nll(p, *batch)) if with_score else None
        return init_fn, loss_fn, (jnp.asarray(x), jnp.asarray(y)), score

    return make_trial


def _torch_trial(x, y, w, with_score):
    def make_trial(configs):
        def init_fn(seed):
            return {k: torch.from_numpy(v.copy()) for k, v in w.items()}

        def nll(p, bx, by):
            h = torch.tanh(bx @ p["w1"] + p["b1"])
            logp = torch.log_softmax(h @ p["w2"] + p["b2"], -1)
            return -torch.gather(logp, 1, by[:, None]).mean()

        def loss_fn(p, batch, hyper):
            l2 = sum((v ** 2).sum() for v in p.values())
            return nll(p, *batch) + hyper["lambd"] * l2

        score = (lambda p, batch: nll(p, *batch)) if with_score else None
        return init_fn, loss_fn, (torch.from_numpy(x), torch.from_numpy(y)), score

    return make_trial


@pytest.mark.parametrize("with_score", [False, True], ids=["neg_final_loss", "score_fn"])
def test_run_vmapped(with_score):
    x, y, w = _mlp_case()
    space = {"lr": {"values": [0.03, 0.01]}, "lambd": {"values": [0.0, 0.05]}}
    jr = J.SweepRunner(space, method="grid").run_vmapped(
        _jax_trial(x, y, w, with_score), num_steps=15, metric="m")
    tr = T.SweepRunner(space, method="grid").run_vmapped(
        _torch_trial(x, y, w, with_score), num_steps=15, metric="m", device=CPU)
    assert [{k: r[k] for k in ("lr", "lambd", "_trial", "_vmapped")} for r in tr.records] == \
        [{k: r[k] for k in ("lr", "lambd", "_trial", "_vmapped")} for r in jr.records]
    got = np.array([r["m"] for r in tr.records])
    want = np.array([r["m"] for r in jr.records])
    # final losses (the negated score without score_fn) at 1e-4, scores at 1e-5
    np.testing.assert_allclose(got, want, rtol=1e-5 if with_score else 1e-4)
    assert tr.best("m")["_trial"] == jr.best("m")["_trial"]


# --------------------------------------------------------------------------
# The nine transforms the tuning configs name
# --------------------------------------------------------------------------

def _clear_spectrum(n=120, g=40, rank=6, seed=0):
    """Counts-like cells x genes of a clear spectrum (gaps of 1.5x), where
    the leading singular vectors are well defined."""
    rng = np.random.default_rng(seed)
    u = np.linalg.qr(rng.normal(size=(n, rank)))[0]
    v = np.linalg.qr(rng.normal(size=(g, rank)))[0]
    x = (u * (40.0 * 0.6 ** np.arange(rank))) @ v.T + 5.0 + 1e-3 * rng.normal(size=(n, g))
    return np.abs(x).astype(np.float32)


def _pair(seed=0, sparse=False, x=None):
    jd = jsyn.annotation_data(120, 40, 3, seed=seed)
    td = tsyn.annotation_data(120, 40, 3, seed=seed)
    np.testing.assert_array_equal(td.data.X, jd.data.X)
    if x is not None:
        jd.data.X, td.data.X = x.copy(), x.copy()
    if sparse:
        jd.data.X, td.data.X = sp.csr_matrix(jd.data.X), sp.csr_matrix(td.data.X)
    return jd, td


def _dense(m):
    return m.toarray() if sp.issparse(m) else np.asarray(m)


NINE = {
    "CellSVD": (lambda m: m.CellSVD(n_components=5), {"device": CPU}, "feature.cell"),
    "FeatureCellPlaceHolder": (lambda m: m.FeatureCellPlaceHolder(), {}, "feature.cell"),
    "ColumnSumNormalize": (lambda m: m.ColumnSumNormalize(), {"device": CPU}, "normalize"),
    "NormalizePlaceHolder": (lambda m: m.NormalizePlaceHolder(), {}, "normalize"),
    "NormalizeTotalLog1P": (lambda m: m.NormalizeTotalLog1P(target_sum=1e4), {},
                            "normalize"),
    "FilterGenesScanpyOrder": (lambda m: m.FilterGenesScanpyOrder(
        order=["min_counts", "min_cells"], min_counts=3, min_cells=0.2), {}, "filter.gene"),
    "HighlyVariableGenesRawCount": (lambda m: m.HighlyVariableGenesRawCount(n_top_genes=20),
                                    {}, "filter.gene"),
    "FilterGenesPlaceHolder": (lambda m: m.FilterGenesPlaceHolder(), {}, "filter.gene"),
    "FilterGenesNumberPlaceHolder": (lambda m: m.FilterGenesNumberPlaceHolder(), {},
                                     "filter.gene"),
}


@pytest.mark.parametrize("name", sorted(NINE))
def test_registered_container_call(name):
    make, extra, scope = NINE[name]
    cls = TREG.get(f"preprocessor.{scope}.{name}")
    assert cls is getattr(TT, name) and JREG.get(f"preprocessor.{scope}.{name}") is not None
    for sparse in (False, True):
        jd, td = _pair(seed=5, sparse=sparse,
                       x=_clear_spectrum(seed=5) if name == "CellSVD" else None)
        jt, tt = make(JT), make(TT)
        for k, v in extra.items():
            setattr(tt, k, v)
        assert tt.hexdigest() == jt.hexdigest() and repr(tt) == repr(jt)
        assert jt(jd) is jd and tt(td) is td
        np.testing.assert_array_equal(td.data.var_names, jd.data.var_names.to_numpy())
        np.testing.assert_array_equal(td.data.obs_names, jd.data.obs_names.to_numpy())
        want, got = _dense(jd.data.X), _dense(td.data.X)
        if name == "ColumnSumNormalize":  # float32 column sums in another order
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
        else:
            np.testing.assert_array_equal(got, want)
        for key in jd.data.var.columns:
            np.testing.assert_array_equal(td.data.var[key], jd.data.var[key].to_numpy(), key)
        for key in jd.data.obsm.keys():
            if key == "cell_type":
                continue
            want = _dense(jd.data.obsm[key])
            got = _dense(td.data.obsm[key])
            if name == "CellSVD":  # another LAPACK's SVD, signs fixed alike
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
                np.testing.assert_allclose(td.data.uns["svd_components"],
                                           jd.data.uns["svd_components"], rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(got, want)
        for key in jd.data.varm.keys():
            np.testing.assert_array_equal(_dense(td.data.varm[key]), _dense(jd.data.varm[key]))
        assert set(td.data.uns.keys()) == set(jd.data.uns.keys())


@pytest.mark.parametrize("target", ["Log1P", "NormalizeTotal", "NormalizeTotalLog1P",
                                    "NormalizePlaceHolder"])
def test_mod_option(target):
    """The joint-embedding and BABEL configs set ``mod: mod1`` on their
    normalize step: the generated pipeline runs on that modality only."""
    with open(os.path.join(REPO, "examples", "tuning", "joint_embedding_dcca",
                           "pipeline_params_tuning_config.yaml")) as f:
        cfg = yaml.safe_load(f)
    jp, tp = J.PipelinePlaner(cfg), T.PipelinePlaner(cfg)
    trial = {"pipeline.0.normalize": target}
    jd = jsyn.multimodal_data(60, 30, 8, seed=11)
    td = tsyn.multimodal_data(60, 30, 8, seed=11)
    jp.generate(pipeline=trial).functional(jd)
    tp.generate(pipeline=trial).functional(td)
    for mod in ("mod1", "mod2"):
        np.testing.assert_array_equal(_dense(td.data.mod[mod].X), _dense(jd.data.mod[mod].X))
    assert target == "NormalizePlaceHolder" or not np.array_equal(
        _dense(td.data.mod["mod1"].X), _dense(tsyn.multimodal_data(60, 30, 8, seed=11)
                                               .data.mod["mod1"].X))
