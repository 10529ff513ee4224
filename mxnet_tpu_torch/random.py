"""Random state: one ``torch.Generator`` per device behind ``seed``, and
the host generator ``host_rng``.

Counterpart of ``mxnet_tpu/random.py`` (``seed``:26, ``host_rng``:35,
``next_key``:49).
JAX threads counter-based keys; here every device has its own
``torch.Generator``, and code that draws (initializers, ``needs_rng``
ops) takes it explicitly from :func:`generator`, never from torch's
global default generator.  The streams do not match JAX's: parity with
the JAX package comes from inputs made with numpy, not from equal draws.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from .context import as_context

__all__ = ["seed", "generator", "host_rng"]

_lock = threading.Lock()
_seed = 0
_gens = {}  # torch.device -> torch.Generator
_host_rng = None  # np.random.Generator once seeded


def seed(seed_state, ctx="all"):
    """Seed every device's generator (``ctx="all"``, and the ones made
    later), or only ``ctx``'s (reference ``mx.random.seed``)."""
    global _seed, _host_rng
    with _lock:
        if ctx == "all":
            _seed = int(seed_state)
            _gens.clear()
            _host_rng = np.random.default_rng(_seed)
        else:
            dev = as_context(ctx).torch_device
            _gens[dev] = torch.Generator(dev).manual_seed(int(seed_state))


def generator(ctx=None):
    """The ``torch.Generator`` of ``ctx`` (default: the current context)."""
    dev = as_context(ctx).torch_device
    with _lock:
        gen = _gens.get(dev)
        if gen is None:
            gen = _gens[dev] = torch.Generator(dev).manual_seed(_seed)
        return gen


def host_rng():
    """The numpy generator of host-side draws (iterator shuffles): after
    ``seed(n)`` a ``np.random.default_rng(n)``, before any seed numpy's
    module state, as in the JAX package, so both shuffle alike."""
    return _host_rng if _host_rng is not None else np.random
