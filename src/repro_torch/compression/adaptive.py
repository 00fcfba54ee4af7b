"""Adaptive top-k: spend bits only when the iterate needs them (the port of
the reference's ``compression/adaptive.py``).

:class:`AdaptiveTopK` is a top-k compressor whose k follows a host-side
schedule between rounds.  k is a plain Python int: a move only changes the
payload width of the next ``compress`` call (PyTorch runs eagerly, so there
is no traced step to rebuild), and ``wire_bits`` always bills the live k.

Policy (the reference's, unchanged):

* **measured δ̂ below target ⇒ grow immediately** — the channel reports its
  achieved per-round contraction (``VectorChannel.transmit(measure=True)``);
  δ̂ < ``delta_target`` means the wire is starving the iterate now, so k
  doubles toward ``k_max`` without waiting out the plateau window.
* **plateau ⇒ grow** — if the gradient norm improved by less than
  ``plateau_tol`` (relative) over the last ``patience`` rounds, double k
  toward ``k_max``.
* **fast progress ⇒ shrink** — if the relative improvement over the window
  is above ``shrink_tol`` and the measured δ̂ meets the target, halve k back
  toward ``k_min``.

``delta_bound`` is the conservative k_min/d floor that holds for every
phase of the run.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

from .sparsify import TopK


class AdaptiveTopK(TopK):
    """Top-k with a host-side k schedule in [k_min, k_max]."""

    def __init__(self, d: int, k_min: int, k_max: int, *,
                 value_bits: int = 32, plateau_tol: float = 0.05,
                 shrink_tol: float = 0.5, patience: int = 3,
                 delta_target: float = 0.5, use_kernel: bool = False):
        if not 1 <= k_min <= k_max <= d:
            raise ValueError(f"adaptive top-k needs 1 <= k_min <= k_max <= d,"
                             f" got k_min={k_min}, k_max={k_max}, d={d}")
        super().__init__(k_min, value_bits=value_bits, use_kernel=use_kernel)
        self.d = int(d)
        self.k_min = int(k_min)
        self.k_max = int(k_max)
        self.plateau_tol = plateau_tol
        self.shrink_tol = shrink_tol
        self.patience = int(patience)
        self.delta_target = delta_target
        self._grad_norms: deque = deque(maxlen=self.patience + 1)
        self.name = f"adaptive_topk[{self.k_min},{self.k_max}]"

    # -- schedule (host-side; call between rounds) ----------------------
    def schedule_update(self, *, grad_norm: Optional[float] = None,
                        measured_delta: Optional[float] = None) -> bool:
        """Feed the measured signals; returns True when k changed.  (The
        reference also emits an ``adaptive_k`` telemetry event per move;
        the port's telemetry is ROADMAP.md Queue 1b item B4.)"""
        old_k = self.k
        if grad_norm is not None:
            self._grad_norms.append(float(grad_norm))
        # δ-targeted control: the measured contraction fell below the
        # target — grow now, with no patience window
        if (measured_delta is not None
                and measured_delta < self.delta_target
                and self.k < self.k_max):
            self.k = min(self.k_max, 2 * self.k)
            self._grad_norms.clear()
            return True
        if len(self._grad_norms) == self._grad_norms.maxlen:
            first, last = self._grad_norms[0], self._grad_norms[-1]
            rel = (first - last) / max(first, 1e-30)
            if rel < self.plateau_tol and self.k < self.k_max:
                self.k = min(self.k_max, 2 * self.k)
            elif (rel > self.shrink_tol and self.k > self.k_min
                  and (measured_delta is None
                       or measured_delta >= self.delta_target)):
                self.k = max(self.k_min, self.k // 2)
            if self.k != old_k:
                self._grad_norms.clear()
        return self.k != old_k

    # -- δ accounting: the guarantee must hold for the whole run --------
    def delta_bound(self, d):
        return min(self.k_min, d) / d
