"""Error feedback (memory) for biased compressors, the port of the
reference's ``compression/error_feedback.py``.

Both schemes are functional (state in, state out) over a stack of sender
rows ``(..., d)`` with one memory row per sender:

* :class:`ErrorFeedback` — classic EF: transmit x̂ = C(x + e), carry
  e ← θ·(x + e − x̂).
* :class:`EF21` — markers-style tracking: every sender keeps an estimate h
  of its own signal and transmits only the compressed innovation
  c = C(x − θ·h); both ends update h ← θ·h + c.

Wire cost is the base compressor's payload in both schemes.
"""
from __future__ import annotations

import torch

from .base import Compressor


class _FeedbackBase:
    """Shared shape: wrap a compressor, keep one (d,) memory per sender."""

    def __init__(self, base: Compressor, damping: float = 1.0):
        if not 0.0 < damping <= 1.0:
            raise ValueError(f"error-feedback damping θ must be in (0, 1], "
                             f"got {damping!r}")
        self.base = base
        self.damping = damping

    def apply(self, x, e, *, generator=None):
        """One round: (signal, memory) → (x̂ seen by the receiver, memory')."""
        raise NotImplementedError


class ErrorFeedback(_FeedbackBase):
    """Classic EF: x̂ = C(x + e), e ← θ(x + e − x̂)."""

    def __init__(self, base: Compressor, damping: float = 1.0):
        super().__init__(base, damping)
        self.name = f"ef({base.name})"

    def apply(self, x, e, *, generator=None):
        xc = x.to(torch.float32) + e
        xhat = self.base.roundtrip(xc, generator=generator).to(torch.float32)
        return xhat.to(x.dtype), self.damping * (xc - xhat)


class EF21(_FeedbackBase):
    """EF21 tracking: x̂ = θh + C(x − θh), h ← x̂ (memory IS the estimate)."""

    def __init__(self, base: Compressor, damping: float = 1.0):
        super().__init__(base, damping)
        self.name = f"ef21({base.name})"

    def apply(self, x, e, *, generator=None):
        c = self.base.roundtrip(
            x.to(torch.float32) - self.damping * e, generator=generator
        ).to(torch.float32)
        xhat = self.damping * e + c
        return xhat.to(x.dtype), xhat


def make_error_feedback(variant, base: Compressor, damping: float = 1.0):
    """"none"/False → None, "ef" → classic, "ef21"/True → tracking."""
    if variant in (None, False, "none"):
        return None
    if variant == "ef":
        return ErrorFeedback(base, damping)
    if variant in (True, "ef21"):
        return EF21(base, damping)
    raise ValueError(f"unknown error-feedback variant {variant!r}")
