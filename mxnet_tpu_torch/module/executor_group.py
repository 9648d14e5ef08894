"""DataParallelExecutorGroup: the batch sliced over contexts, one
executor each (counterpart of ``mxnet_tpu/module/executor_group.py:27-159``).

Each context binds one ``GraphExecutor`` on its slice of the batch
(``_split_slice``: even slices, the last one shorter); ``forward`` and
``backward`` run them in turn, the outputs and input gradients merge by
concatenation on the first context, and ``update_metric`` reads the
merged outputs.  The caller (``Module.update``) sums the gradients of the
executors through its KVStore.  The JAX package's grad_req rules hold:
fixed parameters and labels get ``null``, the data ``write`` only with
``inputs_need_grad``.  With ``shared_group`` (``Module.bind(
shared_module=...)``, one bucket of a ``BucketingModule``) each executor
binds the parameter, aux and gradient arrays of the shared group's
executor of the same context, so one update of them is seen by both.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..base import MXNetError
from ..context import context_list
from ..ndarray.ndarray import NDArray, concatenate, zeros

__all__ = ["DataParallelExecutorGroup"]


def _split_slice(batch_size: int, n: int):
    """Even slices of the batch axis (ref: executor_group.
    _split_input_slice)."""
    step = (batch_size + n - 1) // n
    return [slice(min(i * step, batch_size), min((i + 1) * step, batch_size))
            for i in range(n)]


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, data_shapes, label_shapes=None,
                 param_names=None, for_training=True, inputs_need_grad=False,
                 fixed_param_names=None, grad_req="write", logger=None,
                 shared_group=None):
        self.symbol = symbol
        self.contexts = context_list(list(contexts))
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.param_names = list(param_names or [])
        fixed = set(fixed_param_names or [])
        self.data_names = [d.name for d in data_shapes]
        self.label_names = [x.name for x in (label_shapes or [])]
        self.batch_size = data_shapes[0].shape[0]
        self.slices = _split_slice(self.batch_size, len(self.contexts))
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
        if shared_group is not None \
                and len(shared_group.execs) != len(self.contexts):
            raise MXNetError("shared_module binds another number of "
                             "contexts")
        inputs = set(self.data_names) | set(self.label_names)
        params = set(self.param_names)
        self.execs = []
        for k, (ctx, sl) in enumerate(zip(self.contexts, self.slices)):
            sh = shared_group.execs[k] if shared_group is not None else None
            sh_args, sh_grads = ({}, {}) if sh is None else (
                {n: a for n, a in sh.arg_dict.items() if n in params},
                {n: g for n, g in sh.grad_dict.items() if n in params})
            sh_aux = {} if sh is None else sh.aux_dict

            def bound(table, name, shape, ctx=ctx):
                """The shared group's array of ``name``, else zeros."""
                arr = table.get(name)
                if arr is None:
                    return zeros(shape, ctx=ctx)
                if tuple(arr.shape) != tuple(shape):
                    raise MXNetError(
                        f"shared array '{name}' has shape "
                        f"{tuple(arr.shape)}, this symbol needs "
                        f"{tuple(shape)}")
                return arr

            nslice = sl.stop - sl.start
            args = {}
            for n, s in zip(self.arg_names, arg_shapes):
                if n in inputs:
                    s = (nslice,) + tuple(s[1:])
                args[n] = bound(sh_args, n, s)
            grads = {n: bound(sh_grads, n, args[n].shape)
                     for n in self.arg_names if req[n] != "null"}
            aux = [bound(sh_aux, n, s)
                   for n, s in zip(self.aux_names, aux_shapes)]
            self.execs.append(symbol.bind(ctx, args, args_grad=grads,
                                          grad_req=req, aux_states=aux))

    def set_params(self, arg_params, aux_params, allow_extra=False):
        for ex in self.execs:
            ex.copy_params_from(arg_params, aux_params,
                                allow_extra_params=allow_extra)

    def get_params(self, arg_params: Dict[str, NDArray],
                   aux_params: Dict[str, NDArray]):
        """Copies of the first executor's parameters and aux states (the
        update keeps the executors' parameters equal)."""
        ex = self.execs[0]
        for name in self.param_names:
            if name in ex.arg_dict:
                arg_params[name] = ex.arg_dict[name].copy()
        for name, arr in ex.aux_dict.items():
            aux_params[name] = arr.copy()

    def forward(self, data_batch, is_train: Optional[bool] = None):
        if is_train is None:
            is_train = self.for_training
        one = len(self.execs) == 1
        for ex, sl in zip(self.execs, self.slices):
            feed = {n: a if one else a[sl]
                    for n, a in zip(self.data_names, data_batch.data)}
            if is_train and data_batch.label:
                feed.update((n, a if one else a[sl]) for n, a in
                            zip(self.label_names, data_batch.label))
            ex.forward(is_train=is_train, **feed)

    def backward(self, out_grads=None):
        one = len(self.execs) == 1
        for ex, sl in zip(self.execs, self.slices):
            og = None
            if out_grads is not None:
                og = [g if one else g[sl] for g in (
                    out_grads if isinstance(out_grads, (list, tuple))
                    else [out_grads])]
            ex.backward(out_grads=og)

    def _merge(self, per_exec):
        if len(per_exec) == 1:
            return per_exec[0]
        c0 = self.contexts[0]
        return concatenate([a.as_in_context(c0) for a in per_exec], axis=0)

    def get_outputs(self, merge_multi_context=True):
        n_out = len(self.execs[0].outputs)
        per = [[ex.outputs[i] for ex in self.execs] for i in range(n_out)]
        if merge_multi_context:
            return [self._merge(p) for p in per]
        return per

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True first")
        per = [[ex.grad_dict[n] for ex in self.execs]
               for n in self.data_names]
        if merge_multi_context:
            return [self._merge(p) for p in per]
        return per

    def grad_arrays_of(self, name: str) -> List[NDArray]:
        return [ex.grad_dict[name] for ex in self.execs
                if ex.grad_dict.get(name) is not None]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())
