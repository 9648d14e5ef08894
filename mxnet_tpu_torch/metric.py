"""Evaluation metrics (counterpart of ``mxnet_tpu/metric.py``, the whole
module): EvalMetric base + registry/create, Accuracy, TopKAccuracy, F1,
MCC, Perplexity, MAE, MSE, RMSE, CrossEntropy, NegativeLogLikelihood,
PearsonCorrelation, Loss, CompositeEvalMetric, CustomMetric + np().
They compute in numpy on the host, over ``asnumpy`` (a sync point).
The port keeps its own registry, as it imports nothing of the JAX
package."""
from __future__ import annotations

import numpy as _np

from .base import MXNetError

__all__ = ["EvalMetric", "create", "register", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss",
           "CompositeEvalMetric", "CustomMetric", "np"]

_REG = {}


def register(name: str):
    """Register a metric class under ``name`` (case-insensitive)."""
    def deco(cls):
        _REG[name.lower()] = cls
        return cls
    return deco


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    cls = _REG.get(str(metric).lower())
    if cls is None:
        raise MXNetError(f"unknown metric {metric!r}; registered: "
                         f"{sorted(_REG)}")
    return cls(*args, **kwargs)


def _to_numpy(x):
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    if hasattr(x, "detach"):  # a torch.Tensor
        from .ndarray.ndarray import to_numpy

        return to_numpy(x)
    return _np.asarray(x)


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def update_dict(self, label: dict, pred: dict):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names]
        else:
            label = list(label.values())
        self.update(label, pred)

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

    def get_config(self):
        return {"metric": type(self).__name__, **self._kwargs}

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


@register("acc")
@register("accuracy")
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype("int32").flatten()
            label = label.astype("int32").flatten()
            if label.shape != pred.shape:
                raise MXNetError(
                    f"shape mismatch in Accuracy: {label.shape} vs {pred.shape}")
            self.sum_metric += (pred == label).sum()
            self.num_inst += len(label)


@register("top_k_accuracy")
@register("top_k_acc")
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(f"{name}_{top_k}", output_names, label_names,
                         top_k=top_k)
        self.top_k = top_k

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label).astype("int32")
            topk = _np.argsort(pred, axis=-1)[:, -self.top_k:]
            for j in range(self.top_k):
                self.sum_metric += (topk[:, j].flatten() == label.flatten()).sum()
            self.num_inst += len(label)


@register("f1")
class F1(EvalMetric):
    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names, average=average)
        self.average = average
        self.reset_stats()

    def reset_stats(self):
        self._tp = self._fp = self._fn = 0

    def reset(self):
        super().reset()
        self.reset_stats()

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label).astype("int32").flatten()
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = pred.argmax(axis=-1)
            else:
                pred = (pred.flatten() > 0.5).astype("int32")
            pred = pred.astype("int32").flatten()
            self._tp += int(((pred == 1) & (label == 1)).sum())
            self._fp += int(((pred == 1) & (label == 0)).sum())
            self._fn += int(((pred == 0) & (label == 1)).sum())
            precision = self._tp / max(self._tp + self._fp, 1)
            recall = self._tp / max(self._tp + self._fn, 1)
            f1 = 2 * precision * recall / max(precision + recall, 1e-12)
            self.sum_metric = f1
            self.num_inst = 1


@register("mcc")
class MCC(EvalMetric):
    def __init__(self, name="mcc", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)
        self._tp = self._fp = self._tn = self._fn = 0

    def reset(self):
        super().reset()
        self._tp = self._fp = self._tn = self._fn = 0

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label).astype("int32").flatten()
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = pred.argmax(axis=-1)
            else:
                pred = (pred.flatten() > 0.5)
            pred = pred.astype("int32").flatten()
            self._tp += int(((pred == 1) & (label == 1)).sum())
            self._fp += int(((pred == 1) & (label == 0)).sum())
            self._tn += int(((pred == 0) & (label == 0)).sum())
            self._fn += int(((pred == 0) & (label == 1)).sum())
            num = self._tp * self._tn - self._fp * self._fn
            den = _np.sqrt(float((self._tp + self._fp) * (self._tp + self._fn)
                                * (self._tn + self._fp) * (self._tn + self._fn)))
            self.sum_metric = num / den if den > 0 else 0.0
            self.num_inst = 1


@register("perplexity")
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        loss = 0.0
        num = 0
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label).astype("int32").flatten()
            probs = pred.reshape(-1, pred.shape[-1])[_np.arange(len(label)), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label)
                probs = _np.where(ignore, 1.0, probs)
                num -= int(ignore.sum())
            loss -= _np.log(_np.maximum(probs, 1e-10)).sum()
            num += len(label)
        # accumulate total NLL and token count; exponentiate in get() so
        # multi-batch perplexity is exp(sum/count), not a mean of batch ppls
        self.sum_metric += float(loss)
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, float(_np.exp(self.sum_metric / self.num_inst)))


@register("mae")
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_numpy(label)
            pred = _to_numpy(pred)
            if label.ndim == 1:
                label = label.reshape(label.shape[0], 1)
            if pred.ndim == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += float(_np.abs(label - pred).mean())
            self.num_inst += 1


@register("mse")
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_numpy(label)
            pred = _to_numpy(pred)
            if label.ndim == 1:
                label = label.reshape(label.shape[0], 1)
            if pred.ndim == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += float(((label - pred) ** 2).mean())
            self.num_inst += 1


@register("rmse")
class RMSE(MSE):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        EvalMetric.__init__(self, name, output_names, label_names)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, float(_np.sqrt(self.sum_metric / self.num_inst)))


@register("ce")
@register("cross-entropy")
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_numpy(label).ravel().astype("int32")
            pred = _to_numpy(pred)
            prob = pred[_np.arange(label.shape[0]), label]
            self.sum_metric += float((-_np.log(prob + self.eps)).sum())
            self.num_inst += label.shape[0]


@register("nll_loss")
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps, name, output_names, label_names)


@register("pearsonr")
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_numpy(label).ravel()
            pred = _to_numpy(pred).ravel()
            self.sum_metric += float(_np.corrcoef(pred, label)[0, 1])
            self.num_inst += 1


@register("loss")
class Loss(EvalMetric):
    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        for pred in _as_list(preds):
            loss = float(_to_numpy(pred).sum())
            self.sum_metric += loss
            self.num_inst += int(_np.prod(_to_numpy(pred).shape))


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def update_dict(self, labels, preds):
        for m in self.metrics:
            m.update_dict(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.extend(n if isinstance(n, list) else [n])
            values.extend(v if isinstance(v, list) else [v])
        return (names, values)


class CustomMetric(EvalMetric):
    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        name = name or getattr(feval, "__name__", "custom")
        super().__init__(f"custom({name})", output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            reval = self._feval(_to_numpy(label), _to_numpy(pred))
            if isinstance(reval, tuple):
                sum_metric, num_inst = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy feval into a CustomMetric (ref: metric.np)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = name or getattr(numpy_feval, "__name__", "custom")
    return CustomMetric(feval, name, allow_extra_outputs)
