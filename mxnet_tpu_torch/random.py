"""Random state: one ``torch.Generator`` per device (counterpart of
``mxnet_tpu/random.py``, which splits a threefry key per device).

``seed(s)`` reseeds every device's generator (``ctx`` one device's);
``uniform``, ``normal`` and ``randint`` are ``nd.random``'s samplers;
a generator not seeded yet starts from the last global seed (0 before
any).  Imperative Dropout under ``autograd.record()`` and the NDArray
entry point of a block draw from the generator of the data's device.
The streams do not match JAX's draws: parity tests feed explicit
inputs.

A CUDA graph that draws from one of these generators registers it
(:func:`register_graph`): the capture then records offsets into the
generator's Philox stream, and each replay reads the generator's seed
and offset and advances the offset as the eager draws would, so two
replays draw two masks and K replays from a generator state draw what
K eager calls draw from it.  ``torch.cuda.graph`` registers only the
default generator by itself, and these are the port's own.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch

from .context import resolve

__all__ = ["seed", "generator", "register_graph", "host_generator",
           "uniform", "normal", "randint"]

_LOCK = threading.Lock()
_GENS: Dict[Tuple[str, int], torch.Generator] = {}
_SEED = [0]


def _key(dev: torch.device):
    return dev.type, dev.index or 0


def seed(seed_state: int, ctx="all") -> None:
    """Reseed every device's generator, or only ``ctx``'s."""
    with _LOCK:
        if ctx is None or ctx == "all":
            _SEED[0] = int(seed_state)
            for g in _GENS.values():
                g.manual_seed(int(seed_state))
            return
    generator(ctx).manual_seed(int(seed_state))


def generator(ctx=None) -> torch.Generator:
    """The generator of ``ctx``'s device (default gpu(0))."""
    dev = resolve(ctx)
    with _LOCK:
        g = _GENS.get(_key(dev))
        if g is None:
            g = _GENS[_key(dev)] = torch.Generator(
                device=dev).manual_seed(_SEED[0])
        return g


def register_graph(graph, gen: torch.Generator) -> None:
    """Register the CUDA generator ``gen`` with ``graph`` (a
    ``torch.cuda.CUDAGraph`` whose capture has not begun)."""
    graph.register_generator_state(gen)


def host_generator() -> torch.Generator:
    """A new CPU generator seeded with the last global seed (0 before
    any): the draws of ``Module.init_params``."""
    return torch.Generator().manual_seed(_SEED[0])


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
