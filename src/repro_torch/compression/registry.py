"""Compressor registry: spec strings → Compressor instances (the port of
the reference's ``compression/registry.py``):

    "none"          identity (full precision)
    "topk:0.1"      top-k, k = max(1, round(0.1·d))   (ratio form)
    "topk:32"       top-k, k = 32                     (absolute form)
    "topk_kernel:r" top-k through the hand-written top-k kernels on the
                    card (any d; same payload, same wire bits as "topk")
    "adaptive_topk:<k_min>:<k_max>"         top-k with a host-side k
                                            schedule (defaults 0.05 : 0.5)
    "adaptive_topk_kernel:<k_min>:<k_max>"  the same through the kernels
    "randk:0.1"     random-k (same k grammar)
    "signnorm"      scaled sign, 1 bit/coordinate
    "int8"          block-wise int8, block = 128
    "int8:64"       block-wise int8, block = 64
"""
from __future__ import annotations

from typing import Optional, Union

from .adaptive import AdaptiveTopK
from .base import Compressor, Identity
from .quant import BlockInt8
from .sign import SignNorm
from .sparsify import RandomK, TopK

COMPRESSORS = ("none", "topk", "topk_kernel", "randk", "signnorm", "int8",
               "adaptive_topk", "adaptive_topk_kernel")


def _resolve_k(arg: str, d: int) -> int:
    v = float(arg)
    # ratio form needs a decimal point ("1.0" → k = d, "1" → k = 1)
    if "." in arg and 0 < v <= 1:
        return max(1, min(d, int(round(v * d))))
    return max(1, min(d, int(v)))


def make_compressor(
    spec: Optional[Union[str, Compressor]], d: int
) -> Optional[Compressor]:
    """Resolve a spec string (or pass through a Compressor / None)."""
    if spec is None or isinstance(spec, Compressor):
        return spec
    head, _, arg = spec.partition(":")
    if head == "none":
        return Identity()
    if head in ("topk", "topk_kernel"):
        k = _resolve_k(arg or "0.1", d)
        return TopK(k, use_kernel=head == "topk_kernel")
    if head == "randk":
        return RandomK(_resolve_k(arg or "0.1", d))
    if head in ("adaptive_topk", "adaptive_topk_kernel"):
        lo, _, hi = arg.partition(":")
        k_min = _resolve_k(lo or "0.05", d)
        k_max = _resolve_k(hi or "0.5", d)
        return AdaptiveTopK(d, min(k_min, k_max), max(k_min, k_max),
                            use_kernel=head == "adaptive_topk_kernel")
    if head == "signnorm":
        return SignNorm()
    if head == "int8":
        return BlockInt8(int(arg) if arg else 128)
    raise ValueError(
        f"unknown compressor spec {spec!r}; expected one of {COMPRESSORS}"
    )
