"""Gluon of the port: blocks, layers and losses as ``torch.nn.Module``s."""
from .block import (ActiveTrace, Block, HybridBlock, current_trace,
                    load_numpy_params)
from . import loss, nn, model_zoo

__all__ = ["Block", "HybridBlock", "ActiveTrace", "current_trace",
           "load_numpy_params", "loss", "nn", "model_zoo"]
