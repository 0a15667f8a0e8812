"""Evaluation metrics, the port of ``mxnet_tpu/metric.py``.

API parity with reference ``python/mxnet/metric.py`` (EvalMetric base with
registry/`create`, CompositeEvalMetric, Accuracy, TopKAccuracy, F1, MCC,
Perplexity, MAE/MSE/RMSE, CrossEntropy, NegativeLogLikelihood,
PearsonCorrelation, Loss, Torch, Caffe, CustomMetric, ``np`` decorator).
Metrics accumulate on the host in float64, as in the JAX package: they
are O(batch) work per batch, not device work. The arithmetic is the JAX
module's, line for line; only the device-to-host copies differ (an
NDArray's ``asnumpy``, and :func:`~mxnet_tpu_torch.base.fetch_host` for
a batched copy of several).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence

import numpy as _np

from .base import MXNetError, fetch_host

string_types = (str,)
numeric_types = (float, int, _np.generic)

__all__ = [
    "EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy", "F1",
    "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
    "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch", "Caffe",
    "CustomMetric", "np", "create", "register",
]

_METRIC_REGISTRY: Dict[str, type] = {}


def register(klass):
    _METRIC_REGISTRY[klass.__name__.lower()] = klass
    return klass


def _alias(*names):
    def deco(klass):
        for n in names:
            _METRIC_REGISTRY[n.lower()] = klass
        return klass
    return deco


def create(metric, *args, **kwargs):
    """Create a metric from name / callable / list / instance
    (reference metric.py:create)."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    if isinstance(metric, string_types):
        key = metric.lower()
        if key not in _METRIC_REGISTRY:
            raise MXNetError("metric %r is not registered" % (metric,))
        return _METRIC_REGISTRY[key](*args, **kwargs)
    raise MXNetError("cannot create metric from %r" % (metric,))


def _asnp(x) -> _np.ndarray:
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    return _np.asarray(x)


def _asnp_many(arrays: Sequence[Any]) -> List[_np.ndarray]:
    """One batched device->host transfer for a list of label/pred arrays
    (``base.fetch_host``) instead of one copy each; numpy inputs pass
    through."""
    arrays = list(arrays)
    dev = [i for i, a in enumerate(arrays) if hasattr(a, "_data")]
    out = [None if hasattr(a, "_data") else _np.asarray(a) for a in arrays]
    for i, host in zip(dev, fetch_host([arrays[i]._data.detach()
                                        for i in dev])):
        out[i] = host
    return out


def check_label_shapes(labels, preds, shape=False):
    if not shape:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise MXNetError(
            "Shape of labels %s does not match shape of predictions %s"
            % (str(label_shape), str(pred_shape))
        )


class EvalMetric(object):
    """Base metric accumulator (reference metric.py:68)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    def get_config(self):
        config = self._kwargs.copy()
        config.update({
            "metric": self.__class__.__name__,
            "name": self.name,
            "output_names": self.output_names,
            "label_names": self.label_names,
        })
        return config

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names if name in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names if name in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


@register
@_alias("composite")
class CompositeEvalMetric(EvalMetric):
    """Manage multiple metrics as one (reference metric.py:CompositeEvalMetric)."""

    def __init__(self, metrics=None, name="composite", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)
        if metrics is None:
            metrics = []
        self.metrics = [create(i) for i in metrics]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        try:
            return self.metrics[index]
        except IndexError:
            return ValueError("Metric index {} is out of range 0 and {}".format(
                index, len(self.metrics)))

    def update_dict(self, labels, preds):
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        try:
            for metric in self.metrics:
                metric.reset()
        except AttributeError:
            pass

    def get(self):
        names = []
        values = []
        for metric in self.metrics:
            name, value = metric.get()
            if isinstance(name, string_types):
                name = [name]
            if isinstance(value, numeric_types):
                value = [value]
            names.extend(name)
            values.extend(value)
        return (names, values)

    def get_config(self):
        config = super().get_config()
        config.update({"metrics": [i.get_config() for i in self.metrics]})
        return config


@register
@_alias("acc")
class Accuracy(EvalMetric):
    """Classification accuracy (reference metric.py:363)."""

    def __init__(self, axis=1, name="accuracy", output_names=None, label_names=None):
        super().__init__(name, axis=axis, output_names=output_names, label_names=label_names)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = _to_list(labels), _to_list(preds)
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            pred_label = _asnp(pred_label)
            label = _asnp(label)
            if pred_label.shape != label.shape:
                pred_label = _np.argmax(pred_label, axis=self.axis)
            pred_label = pred_label.astype("int32").ravel()
            label = label.astype("int32").ravel()
            check_label_shapes(label, pred_label, shape=True)
            self.sum_metric += (pred_label == label).sum()
            self.num_inst += len(pred_label)


@register
@_alias("top_k_accuracy", "top_k_acc")
class TopKAccuracy(EvalMetric):
    """Top-k accuracy (reference metric.py:432)."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None, label_names=None):
        super().__init__(name, top_k=top_k, output_names=output_names, label_names=label_names)
        self.top_k = top_k
        assert self.top_k > 1, "Please use Accuracy if top_k is no more than 1"
        self.name += "_%d" % self.top_k

    def update(self, labels, preds):
        labels, preds = _to_list(labels), _to_list(preds)
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            assert len(pred_label.shape) <= 2, "Predictions should be no more than 2 dims"
            pred_label = _np.argsort(_asnp(pred_label).astype("float32"), axis=-1)
            label = _asnp(label).astype("int32")
            num_samples = pred_label.shape[0]
            num_dims = len(pred_label.shape)
            if num_dims == 1:
                self.sum_metric += (pred_label.ravel() == label.ravel()).sum()
            elif num_dims == 2:
                num_classes = pred_label.shape[1]
                top_k = min(num_classes, self.top_k)
                for j in range(top_k):
                    self.sum_metric += (
                        pred_label[:, num_classes - 1 - j].ravel() == label.ravel()
                    ).sum()
            self.num_inst += num_samples


@register
class F1(EvalMetric):
    """Binary F1 score (reference metric.py:605)."""

    def __init__(self, name="f1", output_names=None, label_names=None, average="macro"):
        self.average = average
        self.metrics = _BinaryClassificationMetrics()
        super().__init__(name=name, output_names=output_names, label_names=label_names)

    def update(self, labels, preds):
        labels, preds = _to_list(labels), _to_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            self.metrics.update_binary_stats(_asnp(label), _asnp(pred))
            if self.average == "macro":
                self.sum_metric += self.metrics.fscore
                self.num_inst += 1
                self.metrics.reset_stats()
            else:
                self.sum_metric = self.metrics.fscore * self.metrics.total_examples
                self.num_inst = self.metrics.total_examples

    def reset(self):
        self.sum_metric = 0.0
        self.num_inst = 0
        if hasattr(self, "metrics"):
            self.metrics.reset_stats()


class _BinaryClassificationMetrics(object):
    """tp/fp/fn bookkeeping shared by F1 and MCC (reference metric.py:499)."""

    def __init__(self):
        self.reset_stats()

    def update_binary_stats(self, label, pred):
        pred_label = _np.argmax(pred, axis=1)
        check_label_shapes(label, pred)
        if len(_np.unique(label)) > 2:
            raise ValueError("%s currently only supports binary classification."
                             % self.__class__.__name__)
        label = label.ravel().astype("int32")
        pred_label = pred_label.ravel().astype("int32")
        self.true_positives += ((pred_label == 1) & (label == 1)).sum()
        self.false_positives += ((pred_label == 1) & (label == 0)).sum()
        self.false_negatives += ((pred_label == 0) & (label == 1)).sum()
        self.true_negatives += ((pred_label == 0) & (label == 0)).sum()

    @property
    def precision(self):
        if self.true_positives + self.false_positives > 0:
            return float(self.true_positives) / (self.true_positives + self.false_positives)
        return 0.0

    @property
    def recall(self):
        if self.true_positives + self.false_negatives > 0:
            return float(self.true_positives) / (self.true_positives + self.false_negatives)
        return 0.0

    @property
    def fscore(self):
        if self.precision + self.recall > 0:
            return 2 * self.precision * self.recall / (self.precision + self.recall)
        return 0.0

    @property
    def matthewscc(self):
        if not self.total_examples:
            return 0.0
        true_pos = float(self.true_positives)
        false_pos = float(self.false_positives)
        false_neg = float(self.false_negatives)
        true_neg = float(self.true_negatives)
        terms = [
            (true_pos + false_pos), (true_pos + false_neg),
            (true_neg + false_pos), (true_neg + false_neg),
        ]
        denom = 1.0
        for t in filter(lambda t: t != 0.0, terms):
            denom *= t
        return ((true_pos * true_neg) - (false_pos * false_neg)) / math.sqrt(denom)

    @property
    def total_examples(self):
        return (self.false_negatives + self.false_positives
                + self.true_negatives + self.true_positives)

    def reset_stats(self):
        self.false_positives = 0
        self.false_negatives = 0
        self.true_positives = 0
        self.true_negatives = 0


@register
class MCC(EvalMetric):
    """Matthews correlation coefficient (reference metric.py:686)."""

    def __init__(self, name="mcc", output_names=None, label_names=None, average="macro"):
        self._average = average
        self._metrics = _BinaryClassificationMetrics()
        super().__init__(name=name, output_names=output_names, label_names=label_names)

    def update(self, labels, preds):
        labels, preds = _to_list(labels), _to_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            self._metrics.update_binary_stats(_asnp(label), _asnp(pred))
            if self._average == "macro":
                self.sum_metric += self._metrics.matthewscc
                self.num_inst += 1
                self._metrics.reset_stats()
            else:
                self.sum_metric = self._metrics.matthewscc * self._metrics.total_examples
                self.num_inst = self._metrics.total_examples

    def reset(self):
        self.sum_metric = 0.0
        self.num_inst = 0.0
        if hasattr(self, "_metrics"):
            self._metrics.reset_stats()


@register
class Perplexity(EvalMetric):
    """Perplexity (reference metric.py:787)."""

    def __init__(self, ignore_label, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, ignore_label=ignore_label, axis=axis,
                         output_names=output_names, label_names=label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = _to_list(labels), _to_list(preds)
        assert len(labels) == len(preds)
        labels = _asnp_many(labels)
        preds = _asnp_many(preds)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            assert label.size == pred.size / pred.shape[-1], \
                "shape mismatch: %s vs. %s" % (label.shape, pred.shape)
            label = label.reshape((label.size,)).astype("int32")
            probs = pred.reshape(-1, pred.shape[-1])[_np.arange(label.size), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label).astype(probs.dtype)
                num -= _np.count_nonzero(ignore)  # exact host int
                probs = probs * (1 - ignore) + ignore
            pair_loss = _np.sum(_np.log(_np.maximum(1e-10, probs)))
            loss -= float(pair_loss)  # accumulate in python float64
            num += label.size
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class MAE(EvalMetric):
    """Mean absolute error (reference metric.py:MAE)."""

    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)

    def update(self, labels, preds):
        labels, preds = _to_list(labels), _to_list(preds)
        check_label_shapes(labels, preds)
        labels = _asnp_many(labels)
        preds = _asnp_many(preds)
        for label, pred in zip(labels, preds):
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            err = _np.abs(label - pred).mean()
            self.sum_metric += float(err)  # python-float64 accumulation
            self.num_inst += 1


@register
class MSE(EvalMetric):
    """Mean squared error (reference metric.py:MSE)."""

    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)

    def update(self, labels, preds):
        labels, preds = _to_list(labels), _to_list(preds)
        check_label_shapes(labels, preds)
        labels = _asnp_many(labels)
        preds = _asnp_many(preds)
        for label, pred in zip(labels, preds):
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            err = ((label - pred) ** 2.0).mean()
            self.sum_metric += float(err)  # python-float64 accumulation
            self.num_inst += 1


@register
class RMSE(EvalMetric):
    """Root mean squared error (reference metric.py:RMSE)."""

    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)

    def update(self, labels, preds):
        labels, preds = _to_list(labels), _to_list(preds)
        check_label_shapes(labels, preds)
        labels = _asnp_many(labels)
        preds = _asnp_many(preds)
        for label, pred in zip(labels, preds):
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            err = _np.sqrt(((label - pred) ** 2.0).mean())
            self.sum_metric += float(err)  # python-float64 accumulation
            self.num_inst += 1


@register
@_alias("ce")
class CrossEntropy(EvalMetric):
    """Cross entropy over class probabilities (reference metric.py:1074)."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None, label_names=None):
        super().__init__(name, eps=eps, output_names=output_names, label_names=label_names)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = _to_list(labels), _to_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _asnp(label).ravel()
            pred = _asnp(pred)
            assert label.shape[0] == pred.shape[0]
            prob = pred[_np.arange(label.shape[0]), _np.int64(label)]
            self.sum_metric += (-_np.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


@register
@_alias("nll_loss")
class NegativeLogLikelihood(EvalMetric):
    """NLL (reference metric.py:NegativeLogLikelihood)."""

    def __init__(self, eps=1e-12, name="nll-loss", output_names=None, label_names=None):
        super().__init__(name, eps=eps, output_names=output_names, label_names=label_names)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = _to_list(labels), _to_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _asnp(label).ravel()
            pred = _asnp(pred)
            num_examples = pred.shape[0]
            assert label.shape[0] == num_examples, (label.shape[0], num_examples)
            prob = pred[_np.arange(num_examples, dtype=_np.int64), _np.int64(label)]
            self.sum_metric += (-_np.log(prob + self.eps)).sum()
            self.num_inst += num_examples


@register
@_alias("pearsonr")
class PearsonCorrelation(EvalMetric):
    """Pearson correlation (reference metric.py:PearsonCorrelation)."""

    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)

    def update(self, labels, preds):
        labels, preds = _to_list(labels), _to_list(preds)
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _asnp(label)
            pred = _asnp(pred)
            check_label_shapes(label, pred, shape=True)
            self.sum_metric += float(
                _np.corrcoef(pred.ravel(), label.ravel())[0, 1])
            self.num_inst += 1


@register
class Loss(EvalMetric):
    """Dummy metric for mean of the loss outputs (reference metric.py:Loss)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)

    def update(self, _, preds):
        preds = _asnp_many(_to_list(preds))
        for pred in preds:
            loss = _np.sum(pred)
            self.sum_metric += float(loss)  # python-float64 accumulation
            self.num_inst += pred.size


@register
class Torch(Loss):
    """Kept for parity with reference metric.py:Torch."""

    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)


@register
class Caffe(Loss):
    """Kept for parity with reference metric.py:Caffe."""

    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)


@register
class CustomMetric(EvalMetric):
    """Wrap a ``feval(label, pred)`` function (reference metric.py:CustomMetric)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name, feval=feval, allow_extra_outputs=allow_extra_outputs,
                         output_names=output_names, label_names=label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        labels, preds = _to_list(labels), _to_list(preds)
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            label = _asnp(label)
            pred = _asnp(pred)
            reval = self._feval(label, pred)
            if isinstance(reval, tuple):
                (sum_metric, num_inst) = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1

    def get_config(self):
        raise NotImplementedError("CustomMetric cannot be serialized")


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Decorator turning a numpy feval into a CustomMetric factory
    (reference metric.py:np)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


def _to_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]
