"""Gluon of the port: blocks, layers and losses as ``torch.nn.Module``s,
Parameter handles, the Trainer, the data API and utilities."""
from .block import (ActiveTrace, Block, HybridBlock, SymbolBlock,
                    current_trace, load_numpy_params)
from .parameter import (Constant, DeferredInitializationError, Parameter,
                        ParameterDict)
from .trainer import Trainer
from . import contrib, data, loss, nn, model_zoo, parameter, rnn, utils

__all__ = ["Block", "HybridBlock", "SymbolBlock", "ActiveTrace", "current_trace",
           "load_numpy_params", "Parameter", "ParameterDict", "Constant",
           "DeferredInitializationError", "Trainer", "contrib", "data",
           "loss", "nn", "model_zoo", "parameter", "rnn", "utils"]
