"""The model zoo's dense decoders (the port of the reference's
``models/``): 'G' and 'L' blocks, the layer-pattern decoder and the
:func:`build_model` facade."""
from .api import Model, build_model

__all__ = ["Model", "build_model"]
