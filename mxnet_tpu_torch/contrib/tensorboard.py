"""A batch-end callback that logs the evaluation metric to TensorBoard.

Counterpart of ``mxnet_tpu/contrib/tensorboard.py:1-62``
(``LogMetricsCallback``), with its choice of writer: a ``SummaryWriter``
(``torch.utils.tensorboard``, else ``tensorboardX``) where one imports,
else one JSON object ``{"time", "step", "tag", "value"}`` a line in
``<logging_dir>/scalars.jsonl``.
"""
from __future__ import annotations

import json
import os
import time

__all__ = ["LogMetricsCallback"]


def _make_writer(logging_dir):
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter(logging_dir)
    except Exception:
        pass
    try:
        from tensorboardX import SummaryWriter
        return SummaryWriter(logging_dir)
    except Exception:
        return None


class _JsonlWriter:
    """``add_scalar`` as a line of ``scalars.jsonl``."""

    def __init__(self, logging_dir):
        os.makedirs(logging_dir, exist_ok=True)
        self._path = os.path.join(logging_dir, "scalars.jsonl")

    def add_scalar(self, tag, value, global_step=None):
        with open(self._path, "a") as fh:
            fh.write(json.dumps({"time": time.time(), "step": global_step,
                                 "tag": tag, "value": float(value)}) + "\n")

    def flush(self):
        pass


class LogMetricsCallback:
    """Log each of ``param.eval_metric``'s values at every call, as
    ``<prefix>-<name>`` when a prefix is given, at step 1, 2, ..."""

    def __init__(self, logging_dir, prefix=None):
        self.prefix = prefix
        self.step = 0
        self._writer = _make_writer(logging_dir) or _JsonlWriter(logging_dir)

    def __call__(self, param):
        self.step += 1
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            if self.prefix is not None:
                name = "%s-%s" % (self.prefix, name)
            self._writer.add_scalar(name, value, self.step)
