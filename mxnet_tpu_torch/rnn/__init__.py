"""``mx.rnn``: symbolic RNN cells, the bucketed sentence iterator and
RNN checkpoints (counterpart of ``mxnet_tpu/rnn``), the toolkit of the
PTB LSTM of ``example/rnn/bucketing``.
"""
from .rnn_cell import (RNNParams, BaseRNNCell, RNNCell, LSTMCell, GRUCell,
                       FusedRNNCell, SequentialRNNCell, BidirectionalCell,
                       DropoutCell, ResidualCell, ZoneoutCell)
from .io import BucketSentenceIter, encode_sentences
from .rnn import save_rnn_checkpoint, load_rnn_checkpoint, do_rnn_checkpoint

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ResidualCell", "ZoneoutCell",
           "BucketSentenceIter", "encode_sentences",
           "save_rnn_checkpoint", "load_rnn_checkpoint", "do_rnn_checkpoint"]
