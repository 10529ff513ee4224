"""The pretrained-weight store: files already on disk, nothing downloaded.

Counterpart of ``mxnet_tpu/gluon/model_zoo/model_store.py:16-51``.  The
reference downloads ``<name>.params`` from its model repository; with no
network, :func:`get_model_file` resolves only a file already present,
searching in the JAX package's order: ``root`` (the reference's cache,
``~/.mxnet/models``), then ``MXNET_GLUON_REPO`` read as a local
directory, then the repository's ``zoo/``.  A model built with
``pretrained=True`` loads that file, and raises where there is none.
"""
from __future__ import annotations

import os

from ...base import MXNetError

__all__ = ["get_model_file", "purge", "ModelFileNotFound"]


class ModelFileNotFound(MXNetError, FileNotFoundError):
    """No ``<name>.params`` on disk (the JAX package raises
    ``FileNotFoundError``; the port's errors are ``MXNetError``)."""


def _candidates(root):
    repo_zoo = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "..", "..", "..", "zoo")
    found = [os.path.expanduser(root)]
    env_repo = os.environ.get("MXNET_GLUON_REPO")
    if env_repo and os.path.isdir(os.path.expanduser(env_repo)):
        found.append(os.path.expanduser(env_repo))
    found.append(os.path.normpath(repo_zoo))
    return found


def get_model_file(name, root=os.path.join("~", ".mxnet", "models")):
    """The path of ``<name>.params`` in the first directory of the search
    order that holds it; raises :class:`ModelFileNotFound` naming them all
    where none does."""
    file_name = "{name}.params".format(name=name)
    candidates = _candidates(root)
    for cand in candidates:
        file_path = os.path.join(cand, file_name)
        if os.path.exists(file_path):
            return file_path
    raise ModelFileNotFound(
        "Pretrained model file %s is not found in any of %s and nothing is "
        "downloaded. Copy the .params file into the cache directory (MXNet "
        "model zoo format) to use pretrained=True." % (file_name, candidates))


def purge(root=os.path.join("~", ".mxnet", "models")):
    """Delete the ``.params`` files under ``root``."""
    root = os.path.expanduser(root)
    if not os.path.isdir(root):
        return
    for f in os.listdir(root):
        if f.endswith(".params"):
            os.remove(os.path.join(root, f))
