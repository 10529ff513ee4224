"""RNN checkpoints of ``mx.rnn``: ``save_rnn_checkpoint``,
``load_rnn_checkpoint`` and ``do_rnn_checkpoint`` over ``model.py``'s
files (counterpart of ``mxnet_tpu/rnn/rnn.py``); each cell's
``unpack_weights``/``pack_weights`` is applied on the way out and in.
"""
from __future__ import annotations

from ..model import save_checkpoint, load_checkpoint

__all__ = ["save_rnn_checkpoint", "load_rnn_checkpoint", "do_rnn_checkpoint"]


def _cells_of(cells):
    return cells if isinstance(cells, (list, tuple)) else [cells]


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """save_checkpoint with cell-unpacked weights (ref rnn.py:28)."""
    packed = dict(arg_params)
    for cell in _cells_of(cells):
        packed = cell.unpack_weights(packed)
    save_checkpoint(prefix, epoch, symbol, packed, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """load_checkpoint, re-packing weights per cell (ref rnn.py:58)."""
    symbol, args, auxs = load_checkpoint(prefix, epoch)
    for cell in _cells_of(cells):
        args = cell.pack_weights(args)
    return symbol, args, auxs


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end callback variant (ref rnn.py:86)."""
    period = max(1, int(period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)

    return _callback
