"""Loggers in MXNet's format: a level letter (coloured on a terminal),
the time, the process and the source line before each message.

Counterpart of ``mxnet_tpu/log.py:1-60`` (``get_logger``).
"""
from __future__ import annotations

import logging
import sys

__all__ = ["get_logger"]

CRITICAL = logging.CRITICAL
ERROR = logging.ERROR
WARNING = logging.WARNING
INFO = logging.INFO
DEBUG = logging.DEBUG
NOTSET = logging.NOTSET

_COLORS = {logging.DEBUG: "\x1b[32m", logging.INFO: "\x1b[34m",
           logging.WARNING: "\x1b[33m", logging.ERROR: "\x1b[31m",
           logging.CRITICAL: "\x1b[35m"}


class _Formatter(logging.Formatter):
    """``<L><mmdd HH:MM:SS> <pid> <path>:<line>] <message>``, the level
    letter coloured when ``colored``."""

    def __init__(self, colored=True):
        self.colored = colored
        super().__init__(datefmt="%m%d %H:%M:%S")

    def format(self, record):
        label = record.levelname[0]
        head = "%s%s\x1b[0m" % (_COLORS.get(record.levelno, ""), label) \
            if self.colored else label
        self._style._fmt = head + "%(asctime)s %(process)d %(pathname)s:" \
            "%(lineno)d] %(message)s"
        return super().format(record)


def get_logger(name=None, filename=None, filemode=None, level=WARNING):
    """The logger ``name`` at ``level``; a named logger gets, once, a
    handler to ``filename`` (mode ``filemode``, default append) or to
    stderr, in MXNet's format."""
    logger = logging.getLogger(name)
    if name is not None and not getattr(logger, "_init_done", False):
        logger._init_done = True
        if filename:
            hdlr = logging.FileHandler(filename, filemode or "a")
            hdlr.setFormatter(_Formatter(colored=False))
        else:
            hdlr = logging.StreamHandler(sys.stderr)
            hdlr.setFormatter(_Formatter(
                colored=getattr(sys.stderr, "isatty", lambda: False)()))
        logger.addHandler(hdlr)
    logger.setLevel(level)
    return logger
