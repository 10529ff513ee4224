"""Pretrained weights for the zoo's constructors (``model_store``)."""
from ..model_store import get_model_file


def build(make, name, pretrained, ctx):
    """``make()``, its parameters loaded from ``name``'s file where
    ``pretrained``: the file is looked up first, so a missing one raises
    before anything is built."""
    path = get_model_file(name) if pretrained else None
    net = make()
    if path is not None:
        net.load_params(path, ctx=ctx)
    return net
