"""Gluon losses of the port (counterpart of ``mxnet_tpu/gluon/loss.py``):
``Loss`` and ``SoftmaxCrossEntropyLoss``.  The other losses wait for a
later slice.

A loss returns one value per sample: the mean over every axis but
``batch_axis``.
"""
from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


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
