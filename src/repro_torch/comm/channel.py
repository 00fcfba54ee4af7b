"""The communication-channel layer (worker↔center wire), the port of the
reference's ``comm/channel.py`` for the flat-vector runtime.

A :class:`VectorChannel` owns, in one place:

* **direction** — ``"uplink"`` (m senders → center) or ``"downlink"``
  (center → workers, broadcast);
* **compressor** — a :mod:`repro_torch.compression` spec, resolved ONCE at
  construction;
* **error-feedback state** — per-sender EF / EF21 memory threaded through
  ``transmit`` (state in, state out);
* **Byzantine-injection hook** — update-level attacks corrupt the
  *reconstructed* payloads (compression grants Byzantine senders no
  protection);
* **exact wire accounting** — ``bits_per_round`` is a Python int for a
  :class:`repro_torch.comm.WireLedger`, computed from the PAYLOAD, so
  ``topk_kernel`` and ``topk`` account identically.  An adaptive
  compressor moves its k between rounds: ``transmit``/``transmit_sparse``
  send payloads of the live k, and ``bits_per_round`` bills it.

Senders hold flat ``(d,)`` vectors stacked ``(n_senders, d)`` (or ``(d,)``
when ``n_senders == 1``); every sender row is compressed in one call.  The
reference's pytree ``TreeChannel`` belongs to the mesh-runtime slice.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .._device import resolve_device
from ..compression import make_compressor, make_error_feedback
from ..compression.sparsify import _SparseCompressor

UPLINK = "uplink"
DOWNLINK = "downlink"


def _delta(num, den):
    return torch.where(den > 0, 1.0 - num / torch.clamp(den, min=1e-30),
                       torch.ones_like(den))


def _measured_delta(sent, received):
    """Achieved contraction δ̂ = 1 − ‖x − C(x)‖²/‖x‖² over all senders'
    payloads; 1 where nothing was sent (zero signal)."""
    x32 = sent.to(torch.float32)
    r32 = received.to(torch.float32)
    return _delta(torch.sum((x32 - r32) ** 2), torch.sum(x32 * x32))


def _per_sender_delta(sent, received):
    """Per-sender δ̂_i over an (m, d) stack — one norm ratio per row."""
    x32 = sent.to(torch.float32)
    r32 = received.to(torch.float32)
    return _delta(torch.sum((x32 - r32) ** 2, dim=-1),
                  torch.sum(x32 * x32, dim=-1))


class VectorChannel:
    """Flat-vector senders: ``x`` is ``(n_senders, d)`` (or ``(d,)`` when
    ``n_senders == 1``).  ``spec`` is resolved against ``d`` once, here;
    ``None`` means a full-precision wire (32 bits/coordinate)."""

    def __init__(self, direction: str, spec, d: int, n_senders: int = 1, *,
                 error_feedback: str = "none", damping: float = 1.0,
                 attack_hook: Optional[Callable] = None,
                 value_bits: int = 32):
        if direction not in (UPLINK, DOWNLINK):
            raise ValueError(
                f"direction must be uplink/downlink, got {direction!r}")
        self.direction = direction
        self.n_senders = int(n_senders)
        self.error_feedback = error_feedback
        self.damping = damping
        self.attack_hook = attack_hook
        self.d = int(d)
        self.value_bits = value_bits
        self.compressor = make_compressor(spec, d)
        self.feedback = (
            make_error_feedback(error_feedback, self.compressor, damping)
            if self.compressor is not None else None
        )

    @property
    def is_uplink(self) -> bool:
        return self.direction == UPLINK

    # -- state ----------------------------------------------------------
    def init_state(self, device=None):
        """Fresh per-sender EF memory on ``device`` (default the card); a
        zero-width tensor when the channel carries no feedback (the state's
        structure stays the same)."""
        width = self.d if self.feedback is not None else 0
        shape = (self.n_senders, width) if self.n_senders > 1 else (width,)
        return torch.zeros(shape, dtype=torch.float32,
                           device=resolve_device(device))

    # -- the wire -------------------------------------------------------
    def _rows(self, x):
        return x.reshape(self.n_senders, -1)

    def transmit(self, x, state, *, generator=None, attack_generator=None,
                 measure: bool = False, per_sender: bool = False):
        """One round: compress/EF every sender's vector, reconstruct at the
        receiver, inject Byzantine payloads (when an ``attack_generator``
        is given).  Returns ``(x̂, state')`` — or ``(x̂, state', δ̂)`` with
        ``measure=True``, δ̂ measured BEFORE Byzantine injection; with
        ``per_sender=True`` also the (n_senders,) per-sender δ̂."""
        x_sent = x
        comp, fb = self.compressor, self.feedback
        if comp is not None:
            if fb is not None:
                x, state = fb.apply(x, state, generator=generator)
            else:
                x = comp.roundtrip(x, generator=generator)
        delta = _measured_delta(x_sent, x) if measure else None
        worker_delta = (_per_sender_delta(self._rows(x_sent), self._rows(x))
                        if measure and per_sender else None)
        if self.attack_hook is not None and attack_generator is not None:
            x = self.attack_hook(attack_generator, x)
        if measure:
            if per_sender:
                return x, state, delta, worker_delta
            return x, state, delta
        return x, state

    # -- sparse receive path --------------------------------------------
    @property
    def supports_sparse_receive(self) -> bool:
        """True when :meth:`transmit_sparse` carries this channel's full
        semantics: an uplink whose compressor ships (value, index)
        payloads, with no error-feedback state and no update attack."""
        return (self.is_uplink
                and isinstance(self.compressor, _SparseCompressor)
                and self.feedback is None
                and self.attack_hook is None)

    def transmit_sparse(self, x, state, *, generator=None,
                        measure: bool = False, per_sender: bool = False):
        """Payload-shaped receive: hand the receiver the wire payloads —
        values ``(m, k)`` and int32 indices ``(m, k)`` — instead of m dense
        ``(d,)`` vectors.  Returns ``((vals, idx), state')`` (δ̂ appended
        under ``measure=True``, from the payload norms: with distinct
        indices ‖C(x)‖² = Σ vals²).  The wire and ``bits_per_round`` are
        those of :meth:`transmit`."""
        if not self.supports_sparse_receive:
            raise ValueError(
                "transmit_sparse needs an uplink sparse compressor with no "
                "error feedback and no attack hook — use transmit")
        vals, idx = self.compressor.compress(self._rows(x),
                                             generator=generator)
        idx = idx.to(torch.int32)
        if not measure:
            return (vals, idx), state
        x32 = x.to(torch.float32)
        v32 = vals.to(torch.float32)
        den = torch.sum(x32 * x32)
        delta = _delta(den - torch.sum(v32 ** 2), den)
        if per_sender:
            den_w = torch.sum(self._rows(x32) ** 2, dim=-1)
            worker_delta = _delta(den_w - torch.sum(v32 ** 2, dim=-1), den_w)
            return (vals, idx), state, delta, worker_delta
        return (vals, idx), state, delta

    # -- accounting -----------------------------------------------------
    def bits_per_round(self) -> int:
        """Exact bits one round costs on this channel (a Python int, at the
        compressor's live k): m payloads uplink, ONE broadcast payload
        downlink."""
        payload = (self.compressor.wire_bits(self.d)
                   if self.compressor is not None
                   else self.value_bits * self.d)
        return payload * (self.n_senders if self.is_uplink else 1)
