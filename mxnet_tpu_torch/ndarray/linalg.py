"""``nd.linalg``: the ten ``_linalg_*`` ops under their short names.

Counterpart of ``mxnet_tpu/ndarray/linalg.py``.
"""
from __future__ import annotations

from . import _internal

__all__ = ["gemm", "gemm2", "potrf", "potri", "trsm", "trmm", "sumlogdiag",
           "syrk", "syevd", "gelqf"]

for _name in __all__:
    globals()[_name] = getattr(_internal, "_linalg_" + _name)
