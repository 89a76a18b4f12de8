"""Method base contract and the pretrain mixins (counterpart:
dance_tpu/modules/base.py:21-232).

``fit``/``predict``/``score``/``fit_predict``, and for clustering
``score``/``fit_score`` over ``valid_idx``/``test_idx``. The ``acc``, ``ari``,
``nmi``, ``mse``, ``rmse`` and ``mape`` metrics are ported; any other metric
name raises. ``BasePretrain``
loads a pretrained model from ``pretrain_path`` or pretrains and saves it;
``NNPretrain`` freezes named submodules of the model's ``torch.nn.Module``
and saves its ``state_dict``. ``fit_distributed`` runs ``fit`` as one rank
of a data-parallel fit (:mod:`dance_tpu_torch.parallel`). ``preprocess``
runs the model's ``preprocessing_pipeline`` on a port ``Data`` (base.py:34);
a model whose pipeline is not ported yet raises there, naming its array
front (JAX's ``preprocessing_pipeline`` is abstract).
"""

import inspect
import os
import sys
from abc import ABC, abstractmethod
from contextlib import contextmanager
from time import time
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from dance_tpu_torch.settings import logger
from dance_tpu_torch.utils import acc, ari, mape, mse, nmi, rmse

_METRICS = {"acc": acc, "ari": ari, "mape": mape, "mse": mse, "nmi": nmi, "rmse": rmse}


def resolve_score_func(score_func: Optional[Union[str, Callable]]) -> Callable:
    """A metric by name, or a callable passed through (counterpart:
    dance_tpu/utils/metrics.py:22)."""
    if score_func is None:
        raise ValueError("Scoring function not specified")
    if isinstance(score_func, str):
        if score_func not in _METRICS:
            raise NotImplementedError(f"metric {score_func!r} is not ported yet; "
                                      f"ported: {sorted(_METRICS)}")
        return _METRICS[score_func]
    return score_func


class BaseMethod(ABC):

    _DEFAULT_METRIC: Optional[str] = None
    _DISPLAY_ATTRS: Tuple[str, ...] = ()

    @property
    def name(self) -> str:
        return self.__class__.__name__

    def __repr__(self) -> str:
        attrs = ", ".join(f"{i}={getattr(self, i)!r}" for i in self._DISPLAY_ATTRS)
        return f"{self.name}({attrs})"

    def preprocess(self, data, /, **kwargs):
        """Run ``preprocessing_pipeline(**kwargs)`` on ``data`` in place
        (counterpart: base.py:34). A pipeline that takes ``device`` gets the
        model's unless the caller names one."""
        if "device" in inspect.signature(self.preprocessing_pipeline).parameters \
                and hasattr(self, "device"):
            kwargs.setdefault("device", self.device)
        self.preprocessing_pipeline(**kwargs)(data)

    @classmethod
    def preprocessing_pipeline(cls, device="auto", **kwargs):
        """The ``Compose`` of transforms that prepares a ``Data`` for this
        model (counterpart: base.py:37, abstract there). Models whose
        pipeline is not ported yet raise ``NotImplementedError`` naming
        their array front."""
        module = sys.modules[cls.__module__]
        fronts = sorted(name for name, f in vars(module).items() if name.endswith("_preprocess")
                        and getattr(f, "__module__", None) == cls.__module__)
        raise NotImplementedError(
            f"{cls.__name__}.preprocessing_pipeline (the Data-container pipeline) is not ported "
            f"yet; its array front: {', '.join(fronts) or 'none'} in {cls.__module__}")

    @abstractmethod
    def fit(self, x, y=None, **kwargs):
        ...

    def fit_distributed(self, *args, mesh=None, **kwargs):
        """This rank's part of a data-parallel fit (counterpart: base.py:46).

        Runs ``fit`` inside :func:`~dance_tpu_torch.parallel.mesh.dp_context`
        on ``mesh`` (the current mesh when None): every input the model places
        through :func:`~dance_tpu_torch.parallel.mesh.to_device` takes this
        rank's rows, each training step computes this rank's share of the
        loss and sums the gradients over ``dp``, and every rank ends with
        the same weights: the single fit's math, up to float32 summation
        order. Call it on every rank of a launched process group
        (:func:`~dance_tpu_torch.parallel.mesh.launch`, ``torchrun``).
        A ``use_bsr`` option defaults to False here, as in JAX: the
        block-sparse kernels are single-device programs; scDeepSort and
        graph-sc then shard the adjacency itself (``ShardedCSR``). A model
        whose ``fit`` has no data-parallel path fits whole on every rank."""
        from dance_tpu_torch.parallel.mesh import current_mesh, dp_context
        if "use_bsr" in inspect.signature(self.fit).parameters:
            kwargs.setdefault("use_bsr", False)
        with dp_context(mesh or current_mesh(getattr(self, "device", None))):
            return self.fit(*args, **kwargs)

    def predict_proba(self, x):
        raise NotImplementedError

    @abstractmethod
    def predict(self, x):
        ...

    def score(self, x, y, *, score_func: Optional[Union[str, Callable]] = None,
              return_pred: bool = False) -> Any:
        y_pred = self.predict(x)
        score = resolve_score_func(score_func or self._DEFAULT_METRIC)(y, y_pred)
        return (score, y_pred) if return_pred else score

    def fit_predict(self, x, y=None, **fit_kwargs):
        self.fit(x, y, **fit_kwargs)
        return self.predict(x)


class BaseClassificationMethod(BaseMethod):

    _DEFAULT_METRIC = "acc"


class BaseRegressionMethod(BaseMethod):
    """Counterpart: base.py:206. ``score`` takes ``test_idx``, the rows to
    score, as the JAX deconvolution models' own ``score`` does (dstg.py:133,
    stdgcn.py:491)."""

    _DEFAULT_METRIC = "mse"

    def score(self, x, y, *, score_func: Optional[Union[str, Callable]] = None,
              return_pred: bool = False, test_idx=None) -> Any:
        y_pred = self.predict(x)
        if test_idx is None:
            y_sel, pred_sel = y, y_pred
        else:
            y_sel, pred_sel = np.asarray(y)[test_idx], np.asarray(y_pred)[test_idx]
        score = resolve_score_func(score_func or self._DEFAULT_METRIC)(y_sel, pred_sel)
        return (score, pred_sel) if return_pred else score


class BaseClusteringMethod(BaseMethod):
    """Counterpart: base.py:211. With ``valid_idx``, ``score`` returns the
    metric on the validation and the test indices."""

    _DEFAULT_METRIC = "ari"

    def score(self, x, y, *, score_func: Optional[Union[str, Callable]] = None,
              return_pred: bool = False, valid_idx=None, test_idx=None) -> Any:
        y_pred = self.predict(x)
        func = resolve_score_func(score_func or self._DEFAULT_METRIC)
        if valid_idx is None:
            score = func(y, y_pred)
            return (score, y_pred) if return_pred else score
        scores = {"valid_score": func([y[i] for i in valid_idx], [y_pred[i] for i in valid_idx]),
                  "test_score": func([y[i] for i in test_idx], [y_pred[i] for i in test_idx])}
        return (scores, y_pred) if return_pred else scores

    def fit_score(self, x, y, *, score_func: Optional[Union[str, Callable]] = None,
                  return_pred: bool = False, valid_idx=None, test_idx=None, **fit_kwargs):
        self.fit(x, **fit_kwargs)
        return self.score(x, y, score_func=score_func, return_pred=return_pred,
                          valid_idx=valid_idx, test_idx=test_idx)


class BasePretrain(ABC):
    """Pretrain orchestration (counterpart: base.py:104): with
    ``force_pretrain`` always pretrain; otherwise skip when already
    pretrained, load from ``pretrain_path`` when that file exists, else
    pretrain. A pretrain saves to ``pretrain_path`` when it is set."""

    @property
    def is_pretrained(self) -> bool:
        return getattr(self, "_is_pretrained", False)

    def _pretrain(self, *args, force_pretrain: bool = False, **kwargs):
        pt_path = getattr(self, "pretrain_path", None)
        if not force_pretrain:
            if self.is_pretrained:
                logger.info("Skipping pretrain (already pretrained); "
                            "set force_pretrain=True to redo")
                return
            if pt_path is not None and os.path.isfile(pt_path):
                logger.info("Loading pre-trained model from %s", pt_path)
                self.load_pretrained(pt_path)
                self._is_pretrained = True
                return
        if pt_path is None:
            logger.warning("pretrain_path not set; pre-trained model will not be saved")
        t = time()
        self.pretrain(*args, **kwargs)
        logger.info("Pre-training finished (took %.2f seconds)", time() - t)
        self._is_pretrained = True
        if pt_path is not None:
            self.save_pretrained(pt_path)

    def pretrain(self, *args, **kwargs):
        ...

    def save_pretrained(self, path, **kwargs):
        ...

    def load_pretrained(self, path, **kwargs):
        ...


class NNPretrain(BasePretrain, ABC):
    """:class:`BasePretrain` for a model held as a ``torch.nn.Module`` in the
    attribute named by ``_MODULE_ATTR`` (counterpart: base.py:143).

    ``fix_module(*names)`` freezes named submodules of that module (names as
    ``get_submodule`` takes them): their parameters stop requiring grad, get
    no gradient and so no optimizer update. ``save_pretrained`` and
    ``load_pretrained`` write and read the module's ``state_dict`` with
    ``torch.save``/``torch.load``: the port's own format, not the JAX
    package's pickled parameter trees."""

    _MODULE_ATTR = "model"

    def __init__(self):
        self._frozen: set = set()

    @property
    def _module(self) -> torch.nn.Module:
        return getattr(self, self._MODULE_ATTR)

    def _set_trainable(self, names, trainable: bool):
        for name in names:
            self._module.get_submodule(name).requires_grad_(trainable)

    def fix_module(self, *names: str):
        self._set_trainable(names, False)
        self._frozen.update(names)

    def unfix_module(self, *names: str):
        self._set_trainable(names, True)
        self._frozen.difference_update(names)

    # reference plural aliases
    fix_modules = fix_module
    unfix_modules = unfix_module

    @contextmanager
    def pretrain_context(self, *names: str):
        """Unfreeze ``names`` for the duration of the context (counterpart: base.py:166)."""
        logger.info("Entering pre-training context; unlocking: %s", names)
        self.unfix_module(*names)
        try:
            yield
        finally:
            logger.info("Exiting pre-training context; locking: %s", names)
            self.fix_module(*names)

    def save_pretrained(self, path):
        torch.save(self._module.state_dict(), path)

    def load_pretrained(self, path):
        device = next(self._module.parameters()).device
        self._module.load_state_dict(torch.load(path, map_location=device, weights_only=True))


# the reference class name
TorchNNPretrain = NNPretrain


__all__ = ["BaseClassificationMethod", "BaseClusteringMethod", "BaseMethod", "BasePretrain",
           "BaseRegressionMethod", "NNPretrain", "TorchNNPretrain", "resolve_score_func"]
