"""Gluon ``Trainer``: one optimizer step over a set of Parameters.

Counterpart of ``mxnet_tpu/gluon/trainer.py:45-263`` on one context.
Each Parameter takes one integer slot, which indexes the Updater's state
and the optimizer's update counts alike.  ``step(batch_size)`` scales the
gradients by ``rescale_grad / batch_size``, skips or refuses the
Parameters whose gradient backward has not written since the last step
(the stale-gradient rule), and updates the rest: through one fused
update (``fused_trainer.run_fused_step``) where ``MXNET_FUSED_TRAINER``
allows it and the optimizer ``supports_fused()``, else one ``Updater``
call per Parameter (``_loop_step``), the bit-for-bit oracle of the fused
path.

Every Parameter must live on one context; a kvstore over one context is
the identity, so the specs ``None``, ``"device"`` and ``"local"`` are
taken and nothing is reduced.  Several contexts, another kvstore or a
kvstore instance raise ``MXNetError`` (ROADMAP A.7), and so do
``save_states``/``load_states`` (serialization, A.3).
"""
from __future__ import annotations

from ..base import MXNetError
from .. import capture
from .. import optimizer as opt
from . import fused_trainer as _fused
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

_ONE_CONTEXT_KVSTORES = (None, "device", "local")


def _flatten_params(params):
    """A ParameterDict, dict or list of Parameters -> a checked list."""
    if isinstance(params, (dict, ParameterDict)):
        params = list(params.values())
    if not isinstance(params, (list, tuple)):
        raise ValueError("First argument must be a list or dict of "
                         "Parameters, got %s." % type(params))
    for p in params:
        if not isinstance(p, Parameter):
            raise ValueError("First argument must be a list or dict of "
                             "Parameters, got list of %s." % type(p))
    return list(params)


class Trainer:
    """Couples Parameters with an Optimizer (``optimizer`` a name with
    ``optimizer_params``, or an instance)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device"):
        self._params = _flatten_params(params)
        hyper = dict(optimizer_params or {})
        self._scale = hyper.get("rescale_grad", 1.0)
        self._optimizer = self._make_optimizer(optimizer, hyper)
        self._updater = opt.get_updater(self._optimizer)
        if not (kvstore is None or isinstance(kvstore, str)) \
                or kvstore not in _ONE_CONTEXT_KVSTORES:
            raise MXNetError(
                "kvstore %r: a kvstore that reduces over several contexts "
                "or workers is not ported yet (ROADMAP A.7); on one context "
                "use None, 'device' or 'local'" % (kvstore,))
        self._contexts_checked = False
        self._programs = capture.StepCache("Trainer.step")

    def _make_optimizer(self, optimizer, hyper):
        slots = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if hyper:
                raise ValueError("optimizer_params must be None when an "
                                 "Optimizer instance is given")
            optimizer.param_dict = slots
            return optimizer
        return opt.create(optimizer, param_dict=slots, **hyper)

    def _check_contexts(self):
        """At the first step, once every Parameter is initialized: each
        must live on one context."""
        for param in self._params:
            if len(param._ctx_list or ()) > 1:
                raise MXNetError(
                    "Parameter %s is on several contexts %s: reducing its "
                    "gradient over them is not ported yet (ROADMAP A.7)"
                    % (param.name, param._ctx_list))
        self._contexts_checked = True

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """Update every Parameter with a fresh gradient, the gradient
        normalised by ``batch_size`` (reference ``trainer.py:148``).  A
        stale gradient raises ``UserWarning`` before anything is updated,
        unless ``ignore_stale_grad``, which skips those Parameters."""
        if not self._contexts_checked:
            self._check_contexts()
        self._optimizer.rescale_grad = float(self._scale) / batch_size
        slots = []
        for slot, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            if not param._fresh_grad:
                if not ignore_stale_grad:
                    raise UserWarning(
                        "Gradient of Parameter `%s` has not been updated "
                        "by backward since last `step`. This could mean "
                        "a bug in your model that made it only use a "
                        "subset of the Parameters for this iteration. If "
                        "you are intentionally only using a subset, call "
                        "step with ignore_stale_grad=True to suppress "
                        "this warning and skip updating of Parameters "
                        "with stale gradient" % param.name)
                continue
            slots.append((slot, param))
        if slots:
            if _fused.fused_trainer_enabled() \
                    and self._optimizer.supports_fused():
                _fused.run_fused_step(self, slots)
            else:
                self._loop_step(slots)
        for _, param in slots:
            param._fresh_grad = False

    def _loop_step(self, slots):
        """One ``Updater`` call per Parameter."""
        for slot, param in slots:
            _fused._count_loop_update()
            self._updater(slot, param.grad(), param.data())

    def save_states(self, fname):
        raise MXNetError("Trainer.save_states: serialization is not ported "
                         "yet (ROADMAP A.3)")

    def load_states(self, fname):
        raise MXNetError("Trainer.load_states: serialization is not ported "
                         "yet (ROADMAP A.3)")
