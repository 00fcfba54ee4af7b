"""δ-approximate compressor protocol (Definition 2 of the paper / COMRADE),
the port of the reference's ``compression/base.py``.

An operator ``C : R^d → R^d`` is a *δ-approximate compressor* if
``‖C(x) − x‖² ≤ (1 − δ)‖x‖²`` for all x.  Every compressor factors ``C``
into an explicit wire format: ``compress`` produces the payload a sender
transmits and ``decompress`` is the receiver's reconstruction, so
:meth:`Compressor.wire_bits` is the exact payload size in bits, a static
Python int.

Unlike the reference, whose methods see one ``(d,)`` vector under ``vmap``,
the array methods here take a stack of sender rows ``(..., d)`` and treat
each row on its own, so a channel compresses all m senders in one call
(one kernel launch on the card).
"""
from __future__ import annotations

SCALE_BITS = 32   # one float32 value or scale on the wire


class Compressor:
    """Base class: subclasses implement compress/decompress/wire_bits."""

    name: str = "identity"

    # -- wire format ---------------------------------------------------
    def compress(self, x, *, generator=None):
        """x: (..., d) → payload tuple of tensors, one payload per row."""
        raise NotImplementedError

    def decompress(self, payload, d: int):
        """payload → dense (..., d) reconstruction C(x)."""
        raise NotImplementedError

    def wire_bits(self, d: int) -> int:
        """Exact payload size in bits of one d-vector (static)."""
        raise NotImplementedError

    def delta_bound(self, d: int) -> float:
        """Guaranteed δ with ‖C(x) − x‖² ≤ (1 − δ)‖x‖² (in expectation for
        a random compressor)."""
        raise NotImplementedError

    def roundtrip(self, x, *, generator=None):
        """C(x) = decompress(compress(x)) — what the receiver sees."""
        return self.decompress(self.compress(x, generator=generator),
                               x.shape[-1])


class Identity(Compressor):
    """No compression — full-precision d-vector on the wire (δ = 1)."""

    name = "none"

    def __init__(self, value_bits: int = 32):
        self.value_bits = value_bits

    def compress(self, x, *, generator=None):
        return (x,)

    def decompress(self, payload, d):
        return payload[0]

    def wire_bits(self, d):
        return d * self.value_bits

    def delta_bound(self, d):
        return 1.0


def index_bits(d: int) -> int:
    """Bits for one coordinate index in [0, d)."""
    return max(1, (d - 1).bit_length())
