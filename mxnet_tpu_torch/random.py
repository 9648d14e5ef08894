"""Random state: one ``torch.Generator`` per device, kept by the
resource manager (counterpart of ``mxnet_tpu/random.py``, whose streams
live in its resource manager as threefry keys).

``seed(s)`` reseeds every device's generator from the root seed ``s``
(each device's seed folds its type and id into ``s``, see
``resource.py``); ``seed(s, ctx)`` reseeds only ``ctx``'s.  Generators
are reseeded in place, so one already handed out follows.
``uniform``, ``normal`` and ``randint`` are ``nd.random``'s samplers.
Imperative Dropout under ``autograd.record()`` and the NDArray entry
point of a block draw from the generator of the data's device.  The
streams do not match JAX's draws: parity tests feed explicit inputs.

A CUDA graph that draws from one of these generators registers it
(:func:`register_graph`): the capture then records offsets into the
generator's Philox stream, and each replay reads the generator's seed
and offset and advances the offset as the eager draws would, so two
replays draw two masks and K replays from a generator state draw what
K eager calls draw from it.  ``torch.cuda.graph`` registers only the
default generator by itself, and these are the port's own.
"""
from __future__ import annotations

import torch

from .context import as_context

__all__ = ["seed", "generator", "register_graph", "host_generator",
           "uniform", "normal", "randint"]


def _manager():
    from .resource import resource_manager

    return resource_manager()


def seed(seed_state: int, ctx="all") -> None:
    """Reseed every device's generator, or only ``ctx``'s."""
    if ctx is None or ctx == "all":
        _manager().seed(int(seed_state))
    else:
        _manager().seed(int(seed_state), as_context(ctx))


def generator(ctx=None) -> torch.Generator:
    """The generator of ``ctx``'s device (default: the current
    context's)."""
    return _manager().random(None if ctx is None else as_context(ctx))


def register_graph(graph, gen: torch.Generator) -> None:
    """Register the CUDA generator ``gen`` with ``graph`` (a
    ``torch.cuda.CUDAGraph`` whose capture has not begun)."""
    graph.register_generator_state(gen)


def host_generator() -> torch.Generator:
    """A new CPU generator seeded with the last global seed (0 before
    any): the draws of ``Module.init_params``."""
    return torch.Generator().manual_seed(_manager().root_seed)


def uniform(low=0.0, high=1.0, shape=None, dtype=None, ctx=None, out=None):
    from .ndarray import random as _nd_random

    return _nd_random.uniform(low=low, high=high, shape=shape, dtype=dtype,
                              ctx=ctx, out=out)


def normal(loc=0.0, scale=1.0, shape=None, dtype=None, ctx=None, out=None):
    from .ndarray import random as _nd_random

    return _nd_random.normal(loc=loc, scale=scale, shape=shape, dtype=dtype,
                             ctx=ctx, out=out)


def randint(low, high, shape=None, dtype=None, ctx=None, out=None):
    from .ndarray import random as _nd_random

    return _nd_random.randint(low=low, high=high, shape=shape, dtype=dtype,
                              ctx=ctx, out=out)
