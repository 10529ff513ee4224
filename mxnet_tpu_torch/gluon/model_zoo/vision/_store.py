"""The model store's stand-in: no pretrained weights are in the
repository, and nothing is downloaded."""
from ....base import MXNetError


def no_pretrained(name):
    """Raise for ``pretrained=True`` of the model ``name``."""
    raise MXNetError("pretrained %s: no pretrained weights are available "
                     "(the model store is not ported)" % name)
