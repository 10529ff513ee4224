"""Evaluation metrics.

Counterpart of ``mxnet_tpu/metric.py`` (the non-finite rule :41,
``EvalMetric`` :59, ``_PairAccumulator`` :107, ``create`` :140,
``CompositeEvalMetric`` :155, ``Accuracy`` :191, ``TopKAccuracy`` :211,
``F1`` :236, ``Perplexity`` :257, ``MAE``/``MSE``/``RMSE`` :299-323,
``CrossEntropy`` :324, ``NegativeLogLikelihood`` :341,
``PearsonCorrelation`` :349, ``Loss``/``Torch``/``Caffe`` :359-385,
``CustomMetric`` :388 and ``np`` :414), each registered under the JAX
package's names.  Each metric reduces a (label, prediction) pair of host
numpy arrays to a (sum, count) contribution; ``Perplexity`` picks the
label's probability where the prediction lies (on the card for a card's
output) and brings only those to the host.  A non-finite contribution
is left out of the running sum and counted (:func:`nonfinite_updates`).
"""
from __future__ import annotations

import math

import numpy as _np

from .base import MXNetError
from . import ndarray as nd
from .ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch",
           "Caffe", "CustomMetric", "np", "create", "check_label_shapes",
           "nonfinite_updates"]

_REGISTRY = {}
_NONFINITE = [0]


def nonfinite_updates():
    """How many contributions were left out for being NaN or infinite
    (the JAX package's ``metric_nonfinite_updates`` counter)."""
    return _NONFINITE[0]


def check_label_shapes(labels, preds, shape=False):
    """Raise when label/pred list lengths (or array shapes) disagree."""
    got = (labels.shape, preds.shape) if shape else (len(labels), len(preds))
    if got[0] != got[1]:
        raise ValueError("Shape of labels {} does not match shape of "
                         "predictions {}".format(got[0], got[1]))


def _numpy(x):
    return x.asnumpy() if isinstance(x, NDArray) else _np.asarray(x)


def _column(arr):
    """A 2-D (n, k) view for the regression metrics."""
    a = _numpy(arr)
    return a.reshape(-1, 1) if a.ndim == 1 else a


def _finite_contribution(value):
    """A NaN or infinite contribution would poison the running sum for
    good: it is left out and counted."""
    if math.isfinite(value):
        return True
    _NONFINITE[0] += 1
    return False


class EvalMetric:
    """Running-average metric: (sum_metric, num_inst); ``get`` reports
    their ratio."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names, self.label_names = output_names, label_names
        self._kwargs = kwargs
        self.reset()

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        self.sum_metric, self.num_inst = 0.0, 0

    def get(self):
        if not self.num_inst:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst

    def get_name_value(self):
        names, values = self.get()
        if not isinstance(names, list):
            names, values = [names], [values]
        return list(zip(names, values))


class _PairAccumulator(EvalMetric):
    """Metrics that reduce each (label, pred) pair with :meth:`measure`."""

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            value, count = self.measure(_numpy(label), _numpy(pred))
            if not _finite_contribution(float(value)):
                continue
            self.sum_metric += value
            self.num_inst += count

    def measure(self, label, pred):
        raise NotImplementedError()


def register(klass, *aliases):
    for key in (klass.__name__,) + aliases:
        _REGISTRY[key.lower()] = klass
    return klass


def create(metric, *args, **kwargs):
    """A metric from an instance, a list (a composite) or a registered
    name (``"acc"``, ``"top_k_accuracy"``, ``"ce"``, ...)."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        bundle = CompositeEvalMetric()
        for item in metric:
            bundle.add(create(item, *args, **kwargs))
        return bundle
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    key = str(metric).lower()
    if key not in _REGISTRY:
        raise MXNetError("Cannot find metric '%s'. Registered: %s"
                         % (metric, sorted(_REGISTRY)))
    return _REGISTRY[key](*args, **kwargs)


class CompositeEvalMetric(EvalMetric):
    """Reports every child metric's name and value."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def update(self, labels, preds):
        for child in self.metrics:
            child.update(labels, preds)

    def reset(self):
        for child in getattr(self, "metrics", ()):
            child.reset()

    def get(self):
        names, values = [], []
        for child in self.metrics:
            n, v = child.get()
            names += n if isinstance(n, list) else [n]
            values += v if isinstance(v, list) else [v]
        return names, values


register(CompositeEvalMetric, "composite")


class Accuracy(_PairAccumulator):
    """Top-1 accuracy; predictions are argmaxed along ``axis`` when their
    shape differs from the labels'."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def measure(self, label, pred):
        if pred.shape != label.shape:
            pred = pred.argmax(axis=self.axis)
        check_label_shapes(label.ravel(), pred.ravel(), shape=True)
        hits = pred.astype("int64").ravel() == label.astype("int64").ravel()
        return int(hits.sum()), hits.size


register(Accuracy, "acc")


class TopKAccuracy(_PairAccumulator):
    """Fraction of rows whose label is among the top-k scored classes."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, top_k=top_k)
        if top_k <= 1:
            raise ValueError("use Accuracy for top_k <= 1")
        self.top_k = top_k
        self.name = "%s_%d" % (self.name, top_k)

    def measure(self, label, pred):
        if pred.ndim > 2:
            raise ValueError("Predictions should be no more than 2 dims")
        label = label.astype("int64").ravel()
        if pred.ndim == 1:
            return int((pred.astype("int64") == label).sum()), label.size
        k = min(self.top_k, pred.shape[1])
        ranked = _np.argsort(pred.astype("float32"), axis=1)[:, -k:]
        hits = (ranked == label[:, None]).any(axis=1)
        return int(hits.sum()), label.size


register(TopKAccuracy, "top_k_accuracy", "top_k_acc")


class F1(_PairAccumulator):
    """Binary F1 of the argmaxed predictions, one score a batch."""

    def __init__(self, name="f1", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def measure(self, label, pred):
        label = label.astype("int64").ravel()
        if _np.unique(label).size > 2:
            raise ValueError("F1 currently only supports binary "
                             "classification.")
        decided = pred.argmax(axis=1)
        tp = float(((decided == 1) & (label == 1)).sum())
        fp = float(((decided == 1) & (label == 0)).sum())
        fn = float(((decided == 0) & (label == 1)).sum())
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        score = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        return score, 1


register(F1)


class Perplexity(EvalMetric):
    """exp(mean -log p(label)), positions whose label is ``ignore_label``
    (padding) left out."""

    def __init__(self, ignore_label, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label, axis=axis)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        if len(labels) != len(preds):
            raise ValueError("label/pred list length mismatch")
        for label, pred in zip(labels, preds):
            if label.size != pred.size // pred.shape[-1]:
                raise ValueError("shape mismatch: %s vs. %s"
                                 % (label.shape, pred.shape))
            flat = label.as_in_context(pred.context).reshape((label.size,))
            target_p = nd.pick(pred, flat.astype("int32"),
                               axis=self.axis).asnumpy()
            lab = flat.asnumpy()
            count = target_p.size
            if self.ignore_label is not None:
                masked = lab == self.ignore_label
                count -= int(masked.sum())
                target_p = _np.where(masked, 1.0, target_p)
            value = -float(_np.log(_np.maximum(target_p, 1e-10)).sum())
            if not _finite_contribution(value):
                continue
            self.sum_metric += value
            self.num_inst += count

    def get(self):
        if not self.num_inst:
            return self.name, float("nan")
        return self.name, math.exp(self.sum_metric / self.num_inst)


register(Perplexity)


class MAE(_PairAccumulator):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def measure(self, label, pred):
        return float(_np.abs(_column(label) - _column(pred)).mean()), 1


class MSE(_PairAccumulator):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def measure(self, label, pred):
        return float(((_column(label) - _column(pred)) ** 2).mean()), 1


class RMSE(_PairAccumulator):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def measure(self, label, pred):
        return float(_np.sqrt(((_column(label) - _column(pred)) ** 2)
                              .mean())), 1


for _klass in (MAE, MSE, RMSE):
    register(_klass)


class CrossEntropy(_PairAccumulator):
    """Mean -log p(target) over rows of class probabilities."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def measure(self, label, pred):
        idx = label.ravel().astype("int64")
        if idx.shape[0] != pred.shape[0]:
            raise ValueError("label/pred row mismatch")
        target_p = pred[_np.arange(idx.shape[0]), idx]
        return float(-_np.log(target_p + self.eps).sum()), idx.shape[0]


register(CrossEntropy, "ce")


class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps=eps, name=name, output_names=output_names,
                         label_names=label_names)


register(NegativeLogLikelihood, "nll_loss")


class PearsonCorrelation(_PairAccumulator):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def measure(self, label, pred):
        check_label_shapes(label, pred, shape=True)
        return float(_np.corrcoef(pred.ravel(), label.ravel())[0, 1]), 1


register(PearsonCorrelation, "pearsonr")


class Loss(EvalMetric):
    """Mean of the raw outputs, for heads that output a loss."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        for pred in preds:
            value = float(_numpy(pred).sum())
            if not _finite_contribution(value):
                continue
            self.sum_metric += value
            self.num_inst += pred.size


class Torch(Loss):
    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


class Caffe(Loss):
    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


for _klass in (Loss, Torch, Caffe):
    register(_klass)


class CustomMetric(EvalMetric):
    """A user's ``feval(label, pred)`` on numpy arrays, returning a value
    or a (sum, count) pair."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if "<" in name:
                name = "custom(%s)" % name
        super().__init__(name, output_names, label_names, feval=feval,
                         allow_extra_outputs=allow_extra_outputs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            result = self._feval(_numpy(label), _numpy(pred))
            if isinstance(result, tuple):
                self.sum_metric += result[0]
                self.num_inst += result[1]
            else:
                self.sum_metric += result
                self.num_inst += 1


register(CustomMetric)


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """``numpy_feval`` as a :class:`CustomMetric`."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)
