"""Scaled-sign (sign+norm) compression -- 1 bit per coordinate + one scale
(the port of the reference's ``compression/sign.py``).

    C(x) = (‖x‖₁ / d) · sign(x)

the ℓ₁-scaled signSGD operator.  Error identity (sign(0) := 0 only shrinks
the error):

    ‖x − C(x)‖² ≤ ‖x‖² − ‖x‖₁²/d   ⇒   δ = ‖x‖₁² / (d‖x‖²) ≥ 1/d.

Every sender row of an ``(..., d)`` stack gets its own scale.
"""
from __future__ import annotations

import torch

from .._device import div_exact
from .base import SCALE_BITS, Compressor


class SignNorm(Compressor):
    name = "signnorm"

    def compress(self, x, *, generator=None):
        """x (..., d) → (int8 signs (..., d), float32 scales (...,))."""
        x32 = x.to(torch.float32)
        scale = div_exact(torch.sum(torch.abs(x32), dim=-1), x.shape[-1])
        return torch.sign(x32).to(torch.int8), scale

    def decompress(self, payload, d):
        signs, scale = payload
        return scale[..., None] * signs.to(torch.float32)

    def wire_bits(self, d):
        return d + SCALE_BITS

    def delta_bound(self, d):
        return 1.0 / d
