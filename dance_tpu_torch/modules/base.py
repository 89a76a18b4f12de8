"""Method base contract (counterpart: dance_tpu/modules/base.py:21-101,201-203).

``fit``/``predict``/``score``/``fit_predict``. Only the ``acc`` metric is
ported; any other metric name raises. Not in this slice: the Data-container
preprocessing hooks (``preprocess``/``preprocessing_pipeline``), the
data-parallel ``fit_distributed`` and the pretrain mixins.
"""

from abc import ABC, abstractmethod
from typing import Any, Callable, Optional, Tuple, Union

from dance_tpu_torch.utils import acc

_METRICS = {"acc": acc}


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

    @abstractmethod
    def fit(self, x, y=None, **kwargs):
        ...

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


__all__ = ["BaseClassificationMethod", "BaseMethod", "resolve_score_func"]
