"""Compressor registry: spec strings → Compressor instances (the port of
the reference's ``compression/registry.py`` for this slice):

    "none"          identity (full precision)
    "topk:0.1"      top-k, k = max(1, round(0.1·d))   (ratio form)
    "topk:32"       top-k, k = 32                     (absolute form)
    "topk_kernel:r" top-k through the hand-written top-k kernels on the
                    card (any d; same payload, same wire bits as "topk")
    "adaptive_topk:<k_min>:<k_max>"         top-k with a host-side k
                                            schedule (defaults 0.05 : 0.5)
    "adaptive_topk_kernel:<k_min>:<k_max>"  the same through the kernels

The reference's other heads (randk, signnorm, int8) are a later slice and
raise :class:`NotImplementedError`.
"""
from __future__ import annotations

from typing import Optional, Union

from .adaptive import AdaptiveTopK
from .base import Compressor, Identity
from .sparsify import TopK

COMPRESSORS = ("none", "topk", "topk_kernel", "adaptive_topk",
               "adaptive_topk_kernel")
_LATER = {"randk": "Queue 1b item B2", "signnorm": "Queue 1b item B2",
          "int8": "Queue 1b item B2"}


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
    if head in ("adaptive_topk", "adaptive_topk_kernel"):
        lo, _, hi = arg.partition(":")
        k_min = _resolve_k(lo or "0.05", d)
        k_max = _resolve_k(hi or "0.5", d)
        return AdaptiveTopK(d, min(k_min, k_max), max(k_min, k_max),
                            use_kernel=head == "adaptive_topk_kernel")
    if head in _LATER:
        raise NotImplementedError(
            f"compressor {spec!r} is not ported to repro_torch yet -- "
            f"ROADMAP.md {_LATER[head]}"
        )
    raise ValueError(
        f"unknown compressor spec {spec!r}; expected one of {COMPRESSORS}"
    )
