"""Gluon's recurrent cells and fused recurrent layers (counterpart of
``mxnet_tpu/gluon/rnn``)."""
from .rnn_cell import (BidirectionalCell, DropoutCell, GRUCell,
                       HybridSequentialRNNCell, LSTMCell, RecurrentCell,
                       ResidualCell, RNNCell, SequentialRNNCell, ZoneoutCell)
from .rnn_layer import GRU, LSTM, RNN

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "HybridSequentialRNNCell",
           "BidirectionalCell", "DropoutCell", "ZoneoutCell", "ResidualCell",
           "RNN", "LSTM", "GRU"]
