"""DataParallelExecutorGroup over one context (counterpart of
``mxnet_tpu/module/executor_group.py``).

The JAX package slices the batch over several contexts, one executor
each.  A parameter lives on one device in the port, so the group binds
one ``GraphExecutor`` on one context and a list of several raises
(``context.resolve``; ROADMAP queue A item 7).  It keeps the JAX
package's grad_req rules: fixed parameters and labels get ``null``, the
data ``write`` only with ``inputs_need_grad``.  With ``shared_group``
(``Module.bind(shared_module=...)``, one bucket of a
``BucketingModule``) the executor binds that group's parameter, aux and
gradient arrays themselves, so one update of them is seen by both.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..base import MXNetError
from ..context import resolve
from ..ndarray.ndarray import NDArray, zeros

__all__ = ["DataParallelExecutorGroup"]


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, data_shapes, label_shapes=None,
                 param_names=None, for_training=True, inputs_need_grad=False,
                 fixed_param_names=None, grad_req="write", logger=None,
                 shared_group=None):
        ctx = resolve(list(contexts))
        self.symbol = symbol
        self.contexts = [ctx]
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.param_names = list(param_names or [])
        fixed = set(fixed_param_names or [])
        self.data_names = [d.name for d in data_shapes]
        self.label_names = [x.name for x in (label_shapes or [])]
        self.batch_size = data_shapes[0].shape[0]
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        req: Dict[str, str] = {}
        for name in self.arg_names:
            if name in fixed or name in self.label_names:
                req[name] = "null"
            elif name in self.data_names:
                req[name] = "write" if inputs_need_grad else "null"
            else:
                req[name] = grad_req if for_training else "null"
        shapes = {d.name: d.shape for d in data_shapes}
        shapes.update({x.name: x.shape for x in (label_shapes or [])})
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
        sh = shared_group.execs[0] if shared_group is not None else None
        params = set(self.param_names)
        sh_args, sh_grads = ({}, {}) if sh is None else (
            {n: a for n, a in sh.arg_dict.items() if n in params},
            {n: g for n, g in sh.grad_dict.items() if n in params})
        sh_aux = {} if sh is None else sh.aux_dict

        def bound(table, name, shape):
            """The shared group's array of ``name``, else new zeros."""
            arr = table.get(name)
            if arr is None:
                return zeros(shape, ctx=ctx)
            if tuple(arr.shape) != tuple(shape):
                raise MXNetError(
                    f"shared array '{name}' has shape {tuple(arr.shape)}, "
                    f"this symbol needs {tuple(shape)}")
            return arr

        args = {n: bound(sh_args, n, s)
                for n, s in zip(self.arg_names, arg_shapes)}
        grads = {n: bound(sh_grads, n, args[n].shape)
                 for n in self.arg_names if req[n] != "null"}
        aux = [bound(sh_aux, n, s)
               for n, s in zip(self.aux_names, aux_shapes)]
        self.execs = [symbol.bind(ctx, args, args_grad=grads, grad_req=req,
                                  aux_states=aux)]

    def set_params(self, arg_params, aux_params, allow_extra=False):
        for ex in self.execs:
            ex.copy_params_from(arg_params, aux_params,
                                allow_extra_params=allow_extra)

    def get_params(self, arg_params: Dict[str, NDArray],
                   aux_params: Dict[str, NDArray]):
        """Copies of the executor's parameters and aux states."""
        ex = self.execs[0]
        for name in self.param_names:
            if name in ex.arg_dict:
                arg_params[name] = ex.arg_dict[name].copy()
        for name, arr in ex.aux_dict.items():
            aux_params[name] = arr.copy()

    def forward(self, data_batch, is_train: Optional[bool] = None):
        if is_train is None:
            is_train = self.for_training
        feed = dict(zip(self.data_names, data_batch.data))
        if is_train and data_batch.label:
            feed.update(zip(self.label_names, data_batch.label))
        self.execs[0].forward(is_train=is_train, **feed)

    def backward(self, out_grads=None):
        self.execs[0].backward(out_grads=out_grads)

    def get_outputs(self, merge_multi_context=True):
        outs = self.execs[0].outputs
        return list(outs) if merge_multi_context else [[o] for o in outs]

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True first")
        grads = [self.execs[0].grad_dict[n] for n in self.data_names]
        return grads if merge_multi_context else [[g] for g in grads]

    def grad_arrays_of(self, name: str) -> List[NDArray]:
        g = self.execs[0].grad_dict.get(name)
        return [] if g is None else [g]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())
