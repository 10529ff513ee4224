"""Parallel tier of the PyTorch package.

``zero``: the parts of ``mxnet_tpu/parallel/zero.py`` that the LM's
ZeRO-1 train step uses at one rank.  Sharding over the ranks of a process
group, the mesh and ring attention are not ported yet.
"""
from . import zero

__all__ = ["zero"]
