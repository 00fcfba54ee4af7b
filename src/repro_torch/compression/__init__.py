"""Compression — δ-approximate worker→center communication (the port of
the reference's ``compression`` package for this slice: the protocol, the
identity, top-k and adaptive top-k compressors, EF/EF21 and the spec
registry)."""
from .adaptive import AdaptiveTopK
from .base import Compressor, Identity, index_bits
from .error_feedback import EF21, ErrorFeedback, make_error_feedback
from .registry import COMPRESSORS, make_compressor
from .sparsify import TopK

__all__ = [
    "AdaptiveTopK",
    "COMPRESSORS",
    "Compressor",
    "EF21",
    "ErrorFeedback",
    "Identity",
    "TopK",
    "index_bits",
    "make_compressor",
    "make_error_feedback",
]
