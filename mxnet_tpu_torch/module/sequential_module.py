"""``SequentialModule``: modules chained so that one's outputs feed the
next.

Counterpart of ``mxnet_tpu/module/sequential_module.py:20-224``:
``add(module, take_labels=, auto_wiring=)`` builds the chain; ``forward``
threads the outputs through the stages, ``backward`` threads the input
gradients back in reverse, and every stage but the first is bound with
``inputs_need_grad``.  Each member ``Module`` runs its executor's captured
programs (``executor``): a stage's training ``forward`` and its
``backward`` replay the two stages of one program, the output gradients
copied into the buffers that program was captured on.  ``Module``'s
one-call ``CachedTrainStep`` is not used inside a chain, as in the
reference, which calls the members' ``forward``/``backward``/``update``.

The reference binds every stage after the first with the (name, shape)
of the stage before it, so at float32 whatever the data's dtype
(``DataDesc``'s default); here a stage is bound at the dtype of the
outputs that feed it, so an fp64 chain stays fp64.
"""
from __future__ import annotations

import copy
import logging

import numpy as np

from ..initializer import Uniform
from ..io import DataBatch, DataDesc
from .base_module import BaseModule

__all__ = ["SequentialModule"]


def _output_descs(module, names):
    """``module``'s outputs as ``DataDesc`` named ``names``, at their
    shapes and dtypes: a bound symbol's inferred, else the dtypes of the
    module's own data, position by position."""
    shapes = [s[1] if isinstance(s, tuple) else s.shape
              for s in module.output_shapes]
    symbol = getattr(module, "_symbol", None)
    data = list(module.data_shapes or [])
    if symbol is not None:
        descs = data + list(getattr(module, "_label_shapes", None) or [])
        _, outs, _ = symbol._infer(
            shape_kwargs={d.name: d.shape for d in descs},
            dtype_kwargs={d.name: d.dtype for d in descs
                          if getattr(d, "dtype", None) is not None})
        dtypes = [o.dtype for o in outs]
    else:
        dtypes = [getattr(d, "dtype", np.float32) for d in data]
        dtypes += [np.float32] * (len(shapes) - len(dtypes))
    return [DataDesc(n, s, dtype=t) for n, s, t in zip(names, shapes, dtypes)]


class SequentialModule(BaseModule):
    """Member modules run back to back."""

    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules, self._metas = [], []
        self._label_shapes = self._data_shapes = None

    def add(self, module, **kwargs):
        """Append ``module``.  ``take_labels=True`` routes the chain's
        labels into this stage; ``auto_wiring=True`` renames this stage's
        outputs to the next stage's data names."""
        for key in kwargs:
            if key not in (self.META_TAKE_LABELS, self.META_AUTO_WIRING):
                raise ValueError("unknown meta %r" % key)
        self._modules.append(module)
        self._metas.append(dict(kwargs))
        self.binded = self.params_initialized = False
        self.optimizer_initialized = False
        return self

    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else []

    @property
    def data_shapes(self):
        self._require_bound_()
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        self._require_bound_()
        return self._label_shapes

    @property
    def output_shapes(self):
        self._require_bound_()
        return self._modules[-1].output_shapes

    def _require_bound_(self):
        if not self.binded:
            raise AssertionError("SequentialModule is not bound")

    # -- parameters ----------------------------------------------------------
    def get_params(self):
        self._require_ready()
        arg_params, aux_params = {}, {}
        for module in self._modules:
            arg, aux = module.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return arg_params, aux_params

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Each stage's parameters from the dicts (the names a stage does
        not hold are left to the others) or ``initializer`` (default
        ``Uniform(0.01)``); a name held by two stages raises."""
        if self.params_initialized and not force_init:
            return
        self._require_bound_()
        if initializer is None:
            initializer = Uniform(0.01)
        for module in self._modules:
            module.init_params(initializer=initializer,
                               arg_params=arg_params, aux_params=aux_params,
                               allow_missing=True, force_init=force_init,
                               allow_extra=True)
        seen = {}
        for module in self._modules:
            arg, aux = module.get_params()
            for name in list(arg) + list(aux):
                if name in seen:
                    raise ValueError("duplicate parameter %r in modules %s "
                                     "and %s" % (name, seen[name], module))
                seen[name] = module
        self.params_initialized = True

    # -- binding -------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if shared_module is not None:
            raise ValueError("SequentialModule does not accept shared_module")
        if not self._modules:
            raise ValueError("SequentialModule is empty: add() modules first")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._label_shapes = label_shapes
        my_shapes = data_shapes
        anybody_takes_labels = any(m.get(self.META_TAKE_LABELS)
                                   for m in self._metas)
        last_pos = len(self._modules) - 1
        for pos, (module, meta) in enumerate(zip(self._modules,
                                                 self._metas)):
            last = pos == last_pos
            labels = label_shapes if meta.get(self.META_TAKE_LABELS) or (
                last and not anybody_takes_labels and label_shapes) else None
            # every stage but the first passes gradients back
            module.bind(data_shapes=my_shapes, label_shapes=labels,
                        for_training=for_training,
                        inputs_need_grad=inputs_need_grad if pos == 0
                        else True,
                        force_rebind=force_rebind, grad_req=grad_req)
            if last:
                break
            names = [s[0] for s in module.output_shapes]
            if meta.get(self.META_AUTO_WIRING):
                names = self._modules[pos + 1].data_names
            my_shapes = _output_descs(module, names)
        self.binded = True

    # -- optimizer -----------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._require_ready()
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        for module in self._modules:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    # -- computation ---------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        self._require_ready()
        batch = copy.copy(data_batch)
        for pos, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if pos == len(self._modules) - 1:
                break
            outs = module.get_outputs()
            names = self._modules[pos + 1].data_names
            batch = DataBatch(outs, data_batch.label, pad=data_batch.pad,
                              provide_data=[DataDesc(n, o.shape)
                                            for n, o in zip(names, outs)],
                              provide_label=data_batch.provide_label)

    def backward(self, out_grads=None):
        self._require_ready()
        grads = out_grads
        for pos in range(len(self._modules) - 1, -1, -1):
            module = self._modules[pos]
            module.backward(out_grads=grads)
            if pos == 0:
                break
            grads = module.get_input_grads()

    def update(self):
        self._require_ready()
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        self._require_ready()
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._require_ready()
        if not self.inputs_need_grad:
            raise AssertionError("bind with inputs_need_grad=True first")
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._require_ready()
        consumers = [m for m, meta in zip(self._modules, self._metas)
                     if meta.get(self.META_TAKE_LABELS)]
        for module in consumers or [self._modules[-1]]:
            module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        self._require_bound_()
        for module in self._modules:
            module.install_monitor(mon)
