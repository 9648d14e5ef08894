"""Contrib of the port: ``ndarray``/``nd`` and ``symbol``/``sym`` (the
contrib op namespaces), ``quantization`` (int8 post-training
quantization), ``deploy`` (artifacts for serving) and ``amp`` (mixed
precision in bfloat16)."""
from . import ndarray
from . import ndarray as nd
from . import symbol
from . import symbol as sym
from . import quantization
from . import amp, deploy

__all__ = ["ndarray", "nd", "symbol", "sym", "quantization", "amp",
           "deploy"]
