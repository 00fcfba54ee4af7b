"""Exact integer wire-cost accounting for the worker↔center channels (a
copy of the reference's ``comm/ledger.py`` without its telemetry events,
which are a later slice — ROADMAP.md Queue 1b item B4).

A :class:`WireLedger` is a host-side accumulator of plain Python ints,
never a device value.  Channels know their static bits-per-round and the
run loop records one entry per executed step.

Conventions
-----------
* **uplink** — worker→center payloads; m senders pay m payloads per round.
* **downlink** — center→worker broadcast; the payload is counted ONCE per
  round (broadcast medium), not once per receiver.
* ``rounds`` counts communication rounds (a Remark-5 step is two).
"""
from __future__ import annotations


class WireLedger:
    """Exact integer uplink/downlink bit totals, accumulated host-side."""

    __slots__ = ("uplink_bits", "downlink_bits", "rounds")

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        """Zero the totals."""
        self.uplink_bits: int = 0
        self.downlink_bits: int = 0
        self.rounds: int = 0

    def record(self, *, uplink: int = 0, downlink: int = 0,
               rounds: int = 1) -> None:
        """Add one (or ``rounds``) communication rounds' exact bit cost."""
        self.uplink_bits += int(uplink)
        self.downlink_bits += int(downlink)
        self.rounds += int(rounds)

    @property
    def total_bits(self) -> int:
        return self.uplink_bits + self.downlink_bits

    def snapshot(self) -> dict:
        """Plain-dict view (exact ints) for histories / JSON."""
        return {
            "uplink_bits": self.uplink_bits,
            "downlink_bits": self.downlink_bits,
            "total_bits": self.total_bits,
            "rounds": self.rounds,
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return (f"WireLedger(uplink={self.uplink_bits}, "
                f"downlink={self.downlink_bits}, rounds={self.rounds})")
