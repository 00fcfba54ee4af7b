"""Compression — δ-approximate worker→center communication (the port of
the reference's ``compression`` package for the flat-vector runtime: the
protocol, the identity, top-k, random-k, adaptive top-k, scaled-sign and
block-int8 compressors, EF/EF21 and the spec registry)."""
from .adaptive import AdaptiveTopK
from .base import Compressor, Identity, index_bits
from .error_feedback import EF21, ErrorFeedback, make_error_feedback
from .quant import BlockInt8
from .registry import COMPRESSORS, make_compressor
from .sign import SignNorm
from .sparsify import RandomK, TopK

__all__ = [
    "AdaptiveTopK",
    "BlockInt8",
    "COMPRESSORS",
    "Compressor",
    "EF21",
    "ErrorFeedback",
    "Identity",
    "RandomK",
    "SignNorm",
    "TopK",
    "index_bits",
    "make_compressor",
    "make_error_feedback",
]
