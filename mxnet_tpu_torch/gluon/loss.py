"""Gluon losses of the port (counterpart of ``mxnet_tpu/gluon/loss.py``):
L2Loss, L1Loss, SigmoidBinaryCrossEntropyLoss, SoftmaxCrossEntropyLoss,
KLDivLoss, HuberLoss, HingeLoss, SquaredHingeLoss, LogisticLoss,
TripletLoss, CosineEmbeddingLoss, PoissonNLLLoss and CTCLoss, each the
JAX package's formula op by op.  CTCLoss takes NTC or TNC activations
and NT or TN labels, its blank the last class, and returns the CTC loss
per sequence (the ``CTCLoss`` op, ``ops/nn.py``).

A loss returns one value per sample: the mean over every axis but
``batch_axis`` (TripletLoss and CosineEmbeddingLoss: the value per
sample as is; PoissonNLLLoss: the mean of all, as in the JAX package).
"""
from __future__ import annotations

import math

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
           "LogisticLoss", "TripletLoss", "CosineEmbeddingLoss",
           "PoissonNLLLoss", "CTCLoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis, prefix=None, params=None):
        super().__init__(prefix, params)
        self._weight = weight
        self._batch_axis = batch_axis

    def _mean_nonbatch(self, F, loss):
        axes = tuple(i for i in range(loss.dim()) if i != self._batch_axis)
        return F.mean(loss, axis=axes) if axes else loss


def _softrelu_neg_abs(F, pred):
    return F.activation(-F.abs(pred), act_type="softrelu")


class L2Loss(Loss):
    def __init__(self, weight=1.0, batch_axis=0, prefix=None, params=None):
        super().__init__(weight, batch_axis, prefix, params)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        loss = F.square(label - pred)
        loss = _apply_weighting(F, loss, self._weight / 2, sample_weight)
        return self._mean_nonbatch(F, loss)


class L1Loss(Loss):
    def __init__(self, weight=None, batch_axis=0, prefix=None, params=None):
        super().__init__(weight, batch_axis, prefix, params)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        loss = F.abs(label - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_nonbatch(F, loss)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy on logits (the stable form max(x, 0) - x*z +
    log(1 + exp(-|x|))) or, ``from_sigmoid``, on probabilities."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 prefix=None, params=None):
        super().__init__(weight, batch_axis, prefix, params)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = label.reshape(pred.shape)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = F.relu(pred) - pred * label + \
                    _softrelu_neg_abs(F, pred)
            else:
                log_weight = 1 + (pos_weight - 1) * label
                loss = pred - pred * label + log_weight * (
                    _softrelu_neg_abs(F, pred) + F.relu(-pred))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(F.log(pred + eps) * label
                         + F.log(1.0 - pred + eps) * (1.0 - label))
            else:
                loss = -(F.log(pred + eps) * label * pos_weight
                         + F.log(1.0 - pred + eps) * (1.0 - label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_nonbatch(F, loss)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy over ``axis``: integer class labels
    (``sparse_label``, picked with the index clamped into range) or a
    distribution of the prediction's shape; ``from_logits`` takes
    ``pred`` as log-probabilities already."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, prefix=None, params=None):
        super().__init__(weight, batch_axis, prefix, params)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            label = label.reshape(pred.shape)
            loss = -F.sum(pred * label, axis=self._axis, keepdims=True)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_nonbatch(F, loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 prefix=None, params=None):
        super().__init__(weight, batch_axis, prefix, params)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (F.log(label + 1e-12) - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_nonbatch(F, loss)


class HuberLoss(Loss):
    def __init__(self, rho=1.0, weight=None, batch_axis=0, prefix=None,
                 params=None):
        super().__init__(weight, batch_axis, prefix, params)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        loss = F.abs(label - pred)
        loss = F.where(loss > self._rho, loss - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(loss))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_nonbatch(F, loss)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, prefix=None,
                 params=None):
        super().__init__(weight, batch_axis, prefix, params)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        loss = F.relu(self._margin - pred * label)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_nonbatch(F, loss)


class SquaredHingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, prefix=None,
                 params=None):
        super().__init__(weight, batch_axis, prefix, params)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        loss = F.square(F.relu(self._margin - pred * label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_nonbatch(F, loss)


class LogisticLoss(Loss):
    """Logistic loss on logits; ``label_format`` "signed" (-1/1) or
    "binary" (0/1)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 prefix=None, params=None):
        super().__init__(weight, batch_axis, prefix, params)
        self._label_format = label_format

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = F.relu(pred) - pred * label + _softrelu_neg_abs(F, pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_nonbatch(F, loss)


class TripletLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, prefix=None,
                 params=None):
        super().__init__(weight, batch_axis, prefix, params)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative,
                       sample_weight=None):
        positive = positive.reshape(pred.shape)
        negative = negative.reshape(pred.shape)
        loss = F.sum(F.square(positive - pred) - F.square(negative - pred),
                     axis=self._batch_axis, exclude=True)
        loss = F.relu(loss + self._margin)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class CosineEmbeddingLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, margin=0, prefix=None,
                 params=None):
        super().__init__(weight, batch_axis, prefix, params)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        input1 = input1.reshape(input1.shape[0], -1)
        input2 = input2.reshape(input2.shape[0], -1)
        cos = F.sum(input1 * input2, axis=-1) / (
            F.norm(input1, axis=-1) * F.norm(input2, axis=-1) + 1e-12)
        label = label.reshape(-1)
        loss = F.where(label == 1, 1.0 - cos, F.relu(cos - self._margin))
        return _apply_weighting(F, loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, prefix=None, params=None):
        super().__init__(weight, batch_axis, prefix, params)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def hybrid_forward(self, F, pred, target, sample_weight=None,
                       epsilon=1e-08):
        target = target.reshape(pred.shape)
        if self._from_logits:
            loss = F.exp(pred) - target * pred
        else:
            loss = pred - target * F.log(pred + epsilon)
        if self._compute_full:
            stirling = target * F.log(target + epsilon) - target \
                + 0.5 * F.log(2 * math.pi * (target + epsilon))
            stirling = F.where(target <= 1, F.zeros_like(target), stirling)
            loss = loss + stirling
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss)


class CTCLoss(Loss):
    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 prefix=None, params=None):
        super().__init__(weight, 0, prefix, params)
        self._layout = layout
        self._label_layout = label_layout

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        return super().forward(pred, label, pred_lengths, label_lengths,
                               sample_weight)

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "NTC":
            pred = F.swapaxes(pred, dim1=0, dim2=1)
        if self._label_layout == "TN":
            label = F.swapaxes(label, dim1=0, dim2=1)
        loss = F.CTCLoss(pred, label, pred_lengths, label_lengths,
                         use_data_lengths=pred_lengths is not None,
                         use_label_lengths=label_lengths is not None,
                         blank_label="last")
        return _apply_weighting(F, loss, self._weight, sample_weight)
