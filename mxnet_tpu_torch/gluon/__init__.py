"""Gluon of the port: blocks and layers as ``torch.nn.Module``s."""
from .block import (ActiveTrace, Block, HybridBlock, current_trace,
                    load_numpy_params)
from . import nn, model_zoo

__all__ = ["Block", "HybridBlock", "ActiveTrace", "current_trace",
           "load_numpy_params", "nn", "model_zoo"]
