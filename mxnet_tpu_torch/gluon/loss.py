"""Gluon loss blocks.

Counterpart of ``mxnet_tpu/gluon/loss.py`` (``Loss``:49, ``L2Loss``:82,
``L1Loss``:97, ``HuberLoss``:104, ``HingeLoss``:119, ``SquaredHingeLoss``
:131, ``SigmoidBinaryCrossEntropyLoss``:138, ``SoftmaxCrossEntropyLoss``
:162, ``KLDivLoss``:188, ``CTCLoss``:182), the same formulas through the
same ops, so each loss runs imperatively (``F = nd``) and hybridized
(``F = sym``, traced into the block's cached graph).  Pointwise losses share a
``_PointwiseLoss`` template: subclasses give the per-element residual;
label reshaping (``reshape_like``, which a Symbol takes where it has no
``shape``), sample weighting and the mean over the non-batch axes live
in one place.
"""
from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "L1Loss", "L2Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
           "CTCLoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    """Scale *loss* by a per-sample array and/or a scalar (ref loss.py:31)."""
    if weight is not None:
        if not isinstance(weight, (int, float)):
            raise TypeError("weight must be a number")
        loss = weight * loss
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    return loss


def _reshape_like(F, x, y):
    return F.reshape_like(x, y)


class Loss(HybridBlock):
    """Loss base: remembers the scalar weight and batch axis (ref
    loss.py:49)."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight, self._batch_axis = weight, batch_axis

    def __repr__(self):
        return "%s(batch_axis=%s, w=%s)" % (
            type(self).__name__, self._batch_axis, self._weight)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def _finish(self, F, loss, sample_weight):
        """Common tail: weighting then mean over every non-batch axis."""
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class _PointwiseLoss(Loss):
    """Template for losses of the form mean(residual(pred, label))."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        return self._finish(F, self._residual(F, pred, label), sample_weight)

    def _residual(self, F, pred, label):
        raise NotImplementedError


class L2Loss(_PointwiseLoss):
    r"""``0.5 * w * (pred - label)^2`` (ref loss.py:82)."""

    def __init__(self, weight=1., batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def _residual(self, F, pred, label):
        # fold the 1/2 into the residual so _finish applies weight as-is
        return F.square(pred - label) * 0.5


class L1Loss(_PointwiseLoss):
    r"""``w * |pred - label|`` (ref loss.py:120)."""

    def _residual(self, F, pred, label):
        return F.abs(pred - label)


class HuberLoss(_PointwiseLoss):
    r"""Smoothed L1: quadratic inside ``rho``, linear outside."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight=weight, batch_axis=batch_axis, **kwargs)
        self._rho = rho

    def _residual(self, F, pred, label):
        err = F.abs(pred - label)
        return F.where(err > self._rho,
                       err - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(err))


class HingeLoss(_PointwiseLoss):
    r"""``max(0, margin - pred * label)`` with labels in {-1, 1}."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight=weight, batch_axis=batch_axis, **kwargs)
        self._margin = margin

    def _residual(self, F, pred, label):
        return F.relu(self._margin - pred * label)


class SquaredHingeLoss(HingeLoss):
    r"""``max(0, margin - pred * label)^2``."""

    def _residual(self, F, pred, label):
        return F.square(super()._residual(F, pred, label))


class SigmoidBinaryCrossEntropyLoss(_PointwiseLoss):
    r"""BCE over logits (default) or probabilities (ref loss.py:157)."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight=weight, batch_axis=batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def _residual(self, F, pred, label):
        if self._from_sigmoid:
            tiny = 1e-12
            return -(label * F.log(pred + tiny)
                     + (1. - label) * F.log(1. - pred + tiny))
        # numerically stable logits form:
        #   max(x, 0) - x*z + log1p(exp(-|x|))
        return (F.relu(pred) - pred * label
                + F.Activation(-F.abs(pred), act_type="softrelu"))


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    r"""log-softmax + negative likelihood in one block (ref loss.py:224).

    ``sparse_label`` picks the target-class log-prob; otherwise the label is
    a dense distribution over classes.
    """

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis, self._sparse_label = axis, sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        logp = pred if self._from_logits \
            else F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            nll = -F.pick(logp, label, axis=self._axis, keepdims=True)
        else:
            dist = _reshape_like(F, label, logp)
            nll = -F.sum(logp * dist, axis=self._axis, keepdims=True)
        return self._finish(F, nll, sample_weight)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    r"""``sum label * (log label - log pred)`` (ref loss.py:291)."""

    def __init__(self, from_logits=True, axis=-1, weight=None,
                 batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits, self._axis = from_logits, axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        logp = pred if self._from_logits \
            else F.log_softmax(pred, axis=self._axis)
        div = label * (F.log(label + 1e-12) - logp)
        return self._finish(F, div, sample_weight)


class CTCLoss(Loss):
    """Connectionist Temporal Classification through the
    ``_contrib_CTCLoss`` op.  pred in ``layout`` NTC or TNC, label in
    ``label_layout`` NT or TN; optional ``pred_lengths`` and
    ``label_lengths`` (the op's ``use_data_lengths``/
    ``use_label_lengths``)."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        if layout not in ("NTC", "TNC"):
            raise ValueError("pred layout must be 'NTC' or 'TNC'")
        if label_layout not in ("NT", "TN"):
            raise ValueError("label layout must be 'NT' or 'TN'")
        self._layout, self._label_layout = layout, label_layout
        super().__init__(weight, label_layout.index("N"), **kwargs)

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "NTC":  # the op takes time first
            pred = F.swapaxes(pred, dim1=0, dim2=1)
        if self._batch_axis == 1:
            label = F.swapaxes(label, dim1=0, dim2=1)
        operands, flags = [pred, label], {}
        if pred_lengths is not None:
            operands.append(pred_lengths)
            flags["use_data_lengths"] = True
        if label_lengths is not None:
            operands.append(label_lengths)
            flags["use_label_lengths"] = True
        loss = F.contrib.CTCLoss(*operands, **flags)
        return _apply_weighting(F, loss, self._weight, sample_weight)
