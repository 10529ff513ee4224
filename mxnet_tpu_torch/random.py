"""Random state: one ``torch.Generator`` per device behind ``seed``, and
the host generator ``host_rng``.

Counterpart of ``mxnet_tpu/random.py`` (``seed``:26, ``host_rng``:35,
``next_key``:49, ``current_seed``:80).
JAX threads counter-based keys; here every device has its own
``torch.Generator``, and the ops that draw on the device (``needs_rng``)
take it explicitly from :func:`generator`, never from torch's global
default generator; those streams do not match JAX's.  Host-side draws
(the initializers, iterator shuffles) come from :func:`host_rng`, the
numpy generator that the JAX package uses for them too, so after one
``seed(n)`` both packages initialize and shuffle alike.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from .context import as_context

__all__ = ["seed", "current_seed", "generator", "host_rng"]

_lock = threading.Lock()
_seed = 0
_last_seed = 0  # the last seed given, whatever its context
_gens = {}  # torch.device -> torch.Generator
_host_rng = None  # np.random.Generator once seeded


def seed(seed_state, ctx="all"):
    """Seed every device's generator (``ctx="all"``, and the ones made
    later), or only ``ctx``'s (reference ``mx.random.seed``)."""
    global _seed, _host_rng, _last_seed
    with _lock:
        _last_seed = int(seed_state)
        if ctx == "all":
            _seed = int(seed_state)
            _gens.clear()
            _host_rng = np.random.default_rng(_seed)
        else:
            dev = as_context(ctx).torch_device
            _gens[dev] = torch.Generator(dev).manual_seed(int(seed_state))


def current_seed():
    """The last seed given to :func:`seed` (0 before any), as the JAX
    package's ``current_seed`` returns it."""
    return _last_seed


def generator(ctx=None):
    """The ``torch.Generator`` of ``ctx`` (default: the current context)."""
    dev = as_context(ctx).torch_device
    with _lock:
        gen = _gens.get(dev)
        if gen is None:
            gen = _gens[dev] = torch.Generator(dev).manual_seed(_seed)
        return gen


def host_rng():
    """The numpy generator of host-side draws (initializers, iterator
    shuffles): after ``seed(n)`` a ``np.random.default_rng(n)``, before
    any seed numpy's module state, as in the JAX package, so both draw
    alike."""
    return _host_rng if _host_rng is not None else np.random
