"""Gluon ``Trainer``: one optimizer step over a set of Parameters.

Counterpart of ``mxnet_tpu/gluon/trainer.py:45-263``.
Each Parameter takes one integer slot, which indexes the Updater's state
and the optimizer's update counts alike.  ``step(batch_size)`` scales the
gradients by ``rescale_grad / batch_size``, skips or refuses the
Parameters whose gradient backward has not written since the last step
(the stale-gradient rule), and updates the rest: through one fused
update (``fused_trainer.run_fused_step``) where ``MXNET_FUSED_TRAINER``
allows it and the optimizer ``supports_fused()``, else one ``Updater``
call per Parameter (``_loop_step``), the bit-for-bit oracle of the fused
path.

The kvstore (``kvstore``: None, a name or a ``KVStore``, reference
``:73-82``) is made at the first step, each trainable slot its key;
each step sends the gradients through it before the update (``:218-237``):
the loop pushes and pulls each slot's, the fused step makes one bucketed
``push_pull_all`` round.  A Parameter keeps one buffer whatever its
contexts (``parameter``), so each key has one copy and the round hands
the gradients back as they are, with no copy and no program.

``save_states``/``load_states`` (reference ``:265-310``) write and read
the JAX package's versioned states file: the Updater's states and the
per-slot update counts that Adam's bias correction reads, so a resumed
step continues where the saved run stood.
"""
from __future__ import annotations

from .. import _pickle
from .. import capture
from .. import kvstore as kvs
from .. import optimizer as opt
from ..stream import open_stream
from . import fused_trainer as _fused
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


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
        if not (kvstore is None or isinstance(kvstore, (str, kvs.KVStore))):
            raise TypeError("kvstore must be None, a name or a KVStore, not "
                            "%s" % type(kvstore).__name__)
        self._kvstore_spec = kvstore
        self._kvstore = None
        self._kv_initialized = False
        self._programs = capture.StepCache("Trainer.step")
        for p in self._params:
            p._users.add(self)

    def _drop_programs(self):
        """Forget the fused update's captured programs (a Parameter moved:
        ``Parameter.reset_ctx``)."""
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

    def _init_kvstore(self):
        """At the first step: make the store and give it each trainable
        slot's value."""
        spec = self._kvstore_spec
        if spec:
            store = kvs.create(spec) if isinstance(spec, str) else spec
            for slot, param in enumerate(self._params):
                if param.grad_req != "null":
                    store.init(slot, param.data())
            self._kvstore = store
        self._kv_initialized = True

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
        if not self._kv_initialized:
            self._init_kvstore()
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
        """One store round and one ``Updater`` call per Parameter."""
        for slot, param in slots:
            grad = param.grad()
            if self._kvstore is not None:
                self._kvstore.push(slot, [grad])
                self._kvstore.pull(slot, out=[grad])
            _fused._count_loop_update()
            self._updater(slot, grad, param.data())

    def save_states(self, fname):
        """Write the optimizer's states and update counts to ``fname``: a
        pickled dict ``{"__mxnet_trainer_states__": 2, "updater": <the
        Updater's states pickle>, "index_update_count": {slot: n},
        "num_update": n}``, which either package reads."""
        if self._optimizer is None:
            raise AssertionError("trainer has no optimizer")
        payload = {
            "__mxnet_trainer_states__": 2,
            "updater": self._updater.get_states(),
            "index_update_count":
                {int(k): int(v) for k, v in
                 self._optimizer._index_update_count.items()},
            "num_update": int(self._optimizer.num_update),
        }
        with open_stream(fname, "wb") as fh:
            fh.write(_pickle.dumps(payload))

    def load_states(self, fname):
        """Restore what :meth:`save_states` wrote, or a legacy file (the
        Updater's states pickle alone, which carries no counts).  The
        next step's captured update captures again, once, over the new
        states."""
        with open_stream(fname, "rb") as fh:
            payload = _pickle.loads(fh.read())
        if isinstance(payload, dict) \
                and "__mxnet_trainer_states__" in payload:
            self._updater.set_states(payload["updater"])
            self._optimizer = self._updater.optimizer
            self._optimizer._index_update_count = \
                dict(payload["index_update_count"])
            self._optimizer.num_update = int(payload["num_update"])
        else:
            self._updater.set_states_payload(payload)
            self._optimizer = self._updater.optimizer
