"""The legacy ``mx.rnn`` namespace (counterpart of ``mxnet_tpu/rnn``):
the symbolic RNN cells that BucketingModule language models are built
with, and bucketed sentence input."""
from .io import BucketSentenceIter, encode_sentences
from .rnn_cell import (BaseRNNCell, BidirectionalCell, DropoutCell,
                       FusedRNNCell, GRUCell, LSTMCell, ResidualCell,
                       RNNCell, SequentialRNNCell)

__all__ = ["BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "BidirectionalCell", "DropoutCell",
           "ResidualCell", "FusedRNNCell", "BucketSentenceIter",
           "encode_sentences"]
