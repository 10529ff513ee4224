"""``DataParallelExecutorGroup``: one executor a context, each bound to
its slice of the batch.

Counterpart of ``mxnet_tpu/module/executor_group.py:22-247``.  The batch
is split along axis 0 over the contexts by ``workload``
(``_split_input_slice``), each context binds the symbol at its slice's
shapes (``simple_bind``), and each argument's ``grad_req`` is decided once
(parameters write unless fixed, data only with ``inputs_need_grad``,
labels never).  ``data_arrays``, ``param_arrays``, ``grad_arrays`` and
``aux_arrays`` hold, for each name, the list of its per-context NDArrays:
the copies a kvstore sums and broadcasts.  A batch is copied slice by
slice into the bound inputs; forward and backward run every executor;
``get_outputs`` and ``get_input_grads`` join the slices along axis 0 on
the first context's device, and ``update_metric`` feeds each slice's
labels beside its outputs.  ``get_params`` gives the mean of the
contexts' copies, as the reference does (after an update the weights
are one value; BatchNorm's moving statistics are each context's own).
Bound with a ``shared_group``, each executor holds the donor's
parameter, gradient and auxiliary NDArrays of its context.  A batch is
copied into the bound arrays in place (``executor.load_into``), so the
executors' captured programs replay over the same addresses; a CSR
batch (``io.LibSVMIter``) reaches the bound CSR argument as its parts,
copied into its capacity buffers, each context's rows sliced from the
parts, no dense matrix.
"""
from __future__ import annotations

import torch

from ..context import cpu
from ..executor import Executor, arg_zeros, load_into
from .. import ndarray as nd
from ..ndarray import sparse as _sparse

__all__ = ["DataParallelExecutorGroup", "_split_input_slice"]


def _split_input_slice(batch_size, work_load_list):
    """The batch's slice of each context: shares of ``batch_size`` in
    proportion to ``work_load_list``, rounded, the rest to the last."""
    total = sum(work_load_list)
    if batch_size < len(work_load_list):
        raise ValueError("batch size cannot be smaller than number of "
                         "devices")
    slices, start = [], 0
    for i, w in enumerate(work_load_list):
        n = int(round(batch_size * w / total)) \
            if i < len(work_load_list) - 1 else batch_size - start
        slices.append(slice(start, start + n))
        start += n
    return slices


def _join(arrays):
    """NDArrays joined along axis 0 on the first one's device."""
    if len(arrays) == 1:
        return arrays[0]
    dev = arrays[0]._data.device
    return nd.NDArray(torch.cat([a._data.to(dev) for a in arrays]),
                      arrays[0].context)


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 fixed_param_names=None, grad_req="write", shared_group=None,
                 workload=None, state_names=None):
        self.symbol = symbol
        self.contexts = list(contexts)
        self.num_device = len(self.contexts)
        self.workload = list(workload or [1] * self.num_device)
        self.param_names = list(param_names)
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = list(fixed_param_names or [])
        self.state_names = list(state_names or [])
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
        self.slices = _split_input_slice(self.batch_size, self.workload)
        type_dict = {d.name: d.dtype
                     for d in list(data_shapes) + list(label_shapes or [])
                     if d.dtype is not None}
        self.shares_params = shared_group is not None
        self.execs = []
        for i, ctx in enumerate(self.contexts):
            n = self.slices[i].stop - self.slices[i].start
            shapes = {d.name: (n,) + tuple(d.shape[1:])
                      for d in list(data_shapes) + list(label_shapes or [])}
            if shared_group is None:
                ex = symbol.simple_bind(ctx, grad_req=self.grad_req,
                                        type_dict=type_dict, **shapes)
            else:
                ex = self._bind_shared(ctx, shared_group.execs[i], type_dict,
                                       shapes)
            self.execs.append(ex)
        execs = self.execs
        self.data_arrays = [[e.arg_dict[n] for e in execs]
                            for n in self.data_names]
        self.label_arrays = [[e.arg_dict[n] for e in execs]
                             for n in self.label_names if n in self.arg_names]
        self.param_arrays = [[e.arg_dict[n] for e in execs]
                             for n in self.param_names]
        self.grad_arrays = [[e.grad_dict[n] for e in execs]
                            if self.grad_req.get(n, "null") != "null"
                            else None for n in self.param_names]
        self.aux_arrays = [[e.aux_dict[n] for e in execs]
                           for n in self.aux_names]

    def _bind_shared(self, ctx, donor, type_dict, shapes):
        """Bind on ``ctx`` with ``donor``'s parameter, gradient and
        auxiliary NDArrays where their shapes and dtypes are this symbol's;
        new zeros for the rest.  ``shares_params`` says whether every
        parameter and auxiliary state of every context is shared."""
        args, _, auxs = self.symbol._infer(shape_kwargs=shapes,
                                           dtype_kwargs=type_dict)

        def take(mine, theirs, name, meta):
            """``theirs[name]`` where it is shaped and typed as ``meta``,
            else new zeros; whether it was shared."""
            have = theirs.get(name)
            if have is not None and tuple(have.shape) == tuple(meta.shape) \
                    and have._data.dtype == meta.dtype:
                mine[name] = have
                return True
            mine[name] = arg_zeros(stypes.get(name), meta, ctx)
            return False

        stypes = {n.name: n.attrs.get("__storage_type__")
                  for n in self.symbol._arg_nodes()}
        arg_dict, grad_dict, aux_dict = {}, {}, {}
        shared = True
        for name, meta in zip(self.arg_names, args):
            params = name in self.param_names
            shared &= take(arg_dict, donor.arg_dict if params else {}, name,
                           meta) or not params
            if params and self.grad_req.get(name, "null") != "null":
                take(grad_dict, donor.grad_dict, name, meta)
        for name, meta in zip(self.aux_names, auxs):
            shared &= take(aux_dict, donor.aux_dict, name, meta)
        self.shares_params &= shared
        return Executor._bind(self.symbol, ctx, arg_dict, grad_dict,
                              self.grad_req, aux_dict)

    # -- params ------------------------------------------------------------
    def set_params(self, arg_params, aux_params, allow_extra=False):
        for ex in self.execs:
            ex.copy_params_from(arg_params, aux_params,
                                allow_extra_params=allow_extra)

    def get_params(self, arg_params, aux_params):
        """The mean of each parameter's and aux state's per-context copies,
        as new host NDArrays in the given dicts."""
        for names, arrays, out in ((self.param_names, self.param_arrays,
                                    arg_params),
                                   (self.aux_names, self.aux_arrays,
                                    aux_params)):
            for name, block in zip(names, arrays):
                if len(block) == 1:
                    out[name] = nd.array(block[0], ctx=cpu())
                    continue
                total = block[0]._data.detach().cpu()
                for w in block[1:]:
                    total = total + w._data.detach().cpu()
                out[name] = nd.NDArray(total / len(block), cpu())

    # -- execution ---------------------------------------------------------
    def _load(self, arrays, sources):
        """Copy each batch array into its bound arrays, in place
        (``executor.load_into``): the whole, or each context's slice."""
        for dsts, src in zip(arrays, sources):
            raw = _sparse.raw(src) if isinstance(src, nd.NDArray) \
                else nd.array(src, ctx=cpu())._data
            if len(dsts) == 1:
                load_into(dsts[0], raw)
                continue
            for sl, dst in zip(self.slices, dsts):
                load_into(dst, raw[sl])

    def _load_batch(self, batch):
        self._load(self.data_arrays, batch.data)
        if self.label_arrays and batch.label:
            self._load(self.label_arrays, batch.label)

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
        if out_grads is not None and self.num_device > 1:
            if isinstance(out_grads, nd.NDArray):
                out_grads = [out_grads]
            for sl, ex in zip(self.slices, self.execs):
                ex.backward([nd.NDArray(g._data[sl], g.context)
                             for g in out_grads])
            return
        for ex in self.execs:
            ex.backward(out_grads)

    def get_outputs(self, merge_multi_context=True):
        outs = [[ex.outputs[i] for ex in self.execs]
                for i in range(len(self.execs[0].outputs))]
        return [_join(o) for o in outs] if merge_multi_context else outs

    def get_input_grads(self, merge_multi_context=True):
        assert self.inputs_need_grad
        grads = [[ex.grad_dict[n] for ex in self.execs]
                 for n in self.data_names]
        return [_join(g) for g in grads] if merge_multi_context else grads

    def install_monitor(self, mon):
        """``mon``'s tap (its ``stat_helper``, or ``mon`` itself) on
        every executor."""
        for ex in self.execs:
            ex.set_monitor_callback(getattr(mon, "stat_helper", mon))

    def update_metric(self, eval_metric, labels):
        if self.num_device == 1:
            eval_metric.update(list(labels), self.execs[0].outputs)
            return
        for sl, ex in zip(self.slices, self.execs):
            eval_metric.update([label[sl.start:sl.stop] for label in labels],
                               ex.outputs)
