"""Monitor: tensor-stats tapping during training (counterpart of
``mxnet_tpu/monitor.py``; ref: python/mxnet/monitor.py).

The reference installs executor monitor callbacks on every op output.
As in the JAX package, the monitor taps the observable surface of the
installed module(s): parameters, gradients and head outputs.  Interior
activations are reached by binding the symbol's ``get_internals()``.
On the card a Module step replays one captured CUDA graph; :meth:`toc`
reads copies of the parameters and the gradient and output buffers on
the host after the step, between replays: it adds no capture and does
not change what the step computes.
"""
from __future__ import annotations

import logging
import re
from typing import Callable, List, Optional, Tuple

from .ndarray import NDArray

__all__ = ["Monitor"]


class Monitor:
    def __init__(self, interval: int, stat_func: Optional[Callable] = None,
                 pattern: str = ".*", sort: bool = False):
        if stat_func is None:
            def stat_func(x):
                return x.norm() / (x.size ** 0.5)  # ref default: mean |x|-ish

        self.interval = interval
        self.stat_func = stat_func
        self.re_pattern = re.compile(pattern)
        self.sort = sort
        self.step = 0
        self.activated = False
        self.queue: List[Tuple[int, str, NDArray]] = []
        self._modules = []

    def install(self, module):
        self._modules.append(module)

    def tic(self):
        if self.step % self.interval == 0:
            self.activated = True
            self.queue = []
        self.step += 1

    def toc(self) -> List[Tuple[int, str, str]]:
        if not self.activated:
            return []
        self.activated = False
        for mod in self._modules:
            # a module not yet bound and initialised has nothing to tap
            if not getattr(mod, "params_initialized", False):
                continue
            args, _ = mod.get_params()
            group = getattr(mod, "_exec_group", None)
            for name, arr in args.items():
                if self.re_pattern.match(name):
                    self.queue.append((self.step, name, self.stat_func(arr)))
            if group is not None:
                for name in list(args):
                    grads = group.grad_arrays_of(name)
                    if grads and self.re_pattern.match(name + "_grad"):
                        self.queue.append((self.step, name + "_grad",
                                           self.stat_func(grads[0])))
                # before the first forward there are no outputs
                for oname, out in zip(mod.output_names,
                                      group.get_outputs()):
                    if self.re_pattern.match(oname):
                        self.queue.append((self.step, oname,
                                           self.stat_func(out)))
        res = []
        queue = sorted(self.queue, key=lambda x: x[1]) if self.sort \
            else self.queue
        for n, k, v in queue:
            if isinstance(v, NDArray):
                v = v.asnumpy()
            res.append((n, k, str(v)))
        self.queue = []
        return res

    def toc_print(self):
        for n, k, v in self.toc():
            logging.info("Batch: %7d %30s %s", n, k, v)
