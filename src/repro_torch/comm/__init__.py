"""The worker↔center wire: :class:`VectorChannel` and :class:`WireLedger`."""
from .channel import DOWNLINK, UPLINK, VectorChannel
from .ledger import WireLedger

__all__ = ["DOWNLINK", "UPLINK", "VectorChannel", "WireLedger"]
