"""Contrib of the port: ``ndarray``/``nd`` and ``symbol``/``sym`` (the
contrib op namespaces and the control flow, ``foreach``, ``while_loop``
and ``cond``), ``quantization`` (int8 post-training quantization),
``deploy`` (artifacts for serving), ``amp`` (mixed precision in
bfloat16) and ``onnx`` (ONNX export and import)."""
from . import ndarray
from . import ndarray as nd
from . import symbol
from . import symbol as sym
from . import quantization
from . import amp, control_flow, deploy, onnx
from .control_flow import cond, foreach, while_loop

__all__ = ["ndarray", "nd", "symbol", "sym", "quantization", "amp",
           "deploy", "onnx", "control_flow", "foreach", "while_loop",
           "cond"]
