"""``DataParallelExecutorGroup`` on one context.

Counterpart of ``mxnet_tpu/module/executor_group.py:36``: binds the
symbol with the data and label shapes (``simple_bind``), decides each
argument's ``grad_req`` (parameters write unless fixed, data only with
``inputs_need_grad``, labels never), copies each batch into the bound
arrays and runs forward and backward.  It binds one executor on one
context: a list of several contexts needs the kvstore slice, which is
not ported, and raises.
"""
from __future__ import annotations

from ..base import MXNetError
from ..context import cpu
from .. import ndarray as nd

__all__ = ["DataParallelExecutorGroup"]


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 fixed_param_names=None, grad_req="write"):
        if len(contexts) != 1:
            raise MXNetError(
                "Module on %d contexts %s: data parallelism over several "
                "devices needs the kvstore slice, which is not ported yet; "
                "bind one context" % (len(contexts), list(contexts)))
        self.symbol = symbol
        self.contexts = list(contexts)
        self.num_device = 1
        self.param_names = list(param_names)
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = list(fixed_param_names or [])
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()
        self.data_names = [d.name for d in data_shapes]
        self.label_names = [d.name for d in (label_shapes or [])]

        if isinstance(grad_req, str):
            self.grad_req = {}
            for name in self.arg_names:
                if name in self.param_names:
                    self.grad_req[name] = "null" if name in \
                        self.fixed_param_names else grad_req
                elif name in self.data_names:
                    self.grad_req[name] = grad_req if inputs_need_grad \
                        else "null"
                else:
                    self.grad_req[name] = "null"
        else:
            self.grad_req = dict(grad_req)
        if not for_training:
            self.grad_req = {k: "null" for k in self.arg_names}

        self.batch_size = data_shapes[0].shape[0]
        type_dict = {d.name: d.dtype
                     for d in list(data_shapes) + list(label_shapes or [])
                     if d.dtype is not None}
        shapes = {d.name: d.shape
                  for d in list(data_shapes) + list(label_shapes or [])}
        ex = symbol.simple_bind(self.contexts[0], grad_req=self.grad_req,
                                type_dict=type_dict, **shapes)
        self.execs = [ex]
        self.data_arrays = [[ex.arg_dict[n]] for n in self.data_names]
        self.label_arrays = [[ex.arg_dict[n]] for n in self.label_names
                             if n in self.arg_names]
        self.param_arrays = [[ex.arg_dict[n]] for n in self.param_names]
        self.grad_arrays = [[ex.grad_dict[n]]
                            if self.grad_req.get(n, "null") != "null"
                            else None for n in self.param_names]
        self.aux_arrays = [[ex.aux_dict[n]] for n in self.aux_names]

    # -- params ------------------------------------------------------------
    def set_params(self, arg_params, aux_params, allow_extra=False):
        for ex in self.execs:
            ex.copy_params_from(arg_params, aux_params,
                                allow_extra_params=allow_extra)

    def get_params(self, arg_params, aux_params):
        """Copy the bound parameters and aux states into new host NDArrays
        in the given dicts."""
        for names, arrays, out in ((self.param_names, self.param_arrays,
                                    arg_params),
                                   (self.aux_names, self.aux_arrays,
                                    aux_params)):
            for name, block in zip(names, arrays):
                out[name] = nd.array(block[0], ctx=cpu())

    # -- execution ---------------------------------------------------------
    def _load(self, names, arrays, sources):
        for name, dst, src in zip(names, arrays, sources):
            dst[0]._set_data(src._data if isinstance(src, nd.NDArray)
                             else nd.array(src, ctx=cpu())._data)

    def _load_batch(self, batch):
        self._load(self.data_names, self.data_arrays, batch.data)
        if self.label_arrays and batch.label:
            self._load(self.label_names, self.label_arrays, batch.label)

    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        self._load_batch(data_batch)
        for ex in self.execs:
            ex.forward(is_train=is_train)

    def forward_backward(self, data_batch):
        assert self.for_training, \
            "re-bind with for_training=True to run backward"
        self._load_batch(data_batch)
        for ex in self.execs:
            ex.forward_backward()

    def backward(self, out_grads=None):
        assert self.for_training, \
            "re-bind with for_training=True to run backward"
        for ex in self.execs:
            ex.backward(out_grads)

    def get_outputs(self, merge_multi_context=True):
        outs = self.execs[0].outputs
        return list(outs) if merge_multi_context else [[o] for o in outs]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(list(labels), self.execs[0].outputs)
