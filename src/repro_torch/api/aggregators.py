"""Aggregator registry: spec strings → resolved :class:`Aggregator`.

The port of the reference's ``api/aggregators.py`` for this slice:

    "mean"                  plain average (non-robust reference)
    "norm_trim:0.25"        paper's rule — drop the β·m largest-norm
                            updates, average the rest (β ∈ (0, 1))

``agg(updates)`` takes the flat ``(m, d)`` stack and returns
``(aggregate (d,), keep mask (m,))``; ``agg.sparse(vals, idx, d)`` does the
same on the top-k wire payloads without densifying them.  The other rules
of the reference (krum, trimmed_mean, coordinate_median and their
``*_kernel`` heads) are later slices and raise
:class:`NotImplementedError`.
"""
from __future__ import annotations

import torch

from ..core import aggregation as _agg
from ..kernels import aggregate_sparse
from .errors import SpecError, not_ported

AGGREGATOR_SPECS = ("mean", "norm_trim:<beta>")
_LATER = ("krum", "trimmed_mean", "coordinate_median", "krum_kernel",
          "trimmed_mean_kernel", "coordinate_median_kernel")


class Aggregator:
    """A resolved aggregation rule."""

    spec: str
    name: str
    #: True when :meth:`sparse` aggregates wire payloads directly
    supports_sparse = False

    def __call__(self, updates):
        """(m, d) stacked updates → (aggregate (d,), keep mask (m,))."""
        raise NotImplementedError

    def check_resilience(self, alpha: float, m: int):
        """None when the rule tolerates Byzantine fraction ``alpha`` at
        cluster size ``m``; otherwise the reason + fix (a build error)."""
        return None

    def sparse(self, vals, idx, d: int):
        """(m, k) payload values + (m, k) int32 indices (index-ascending,
        distinct within each worker) → the same (aggregate, keep) as
        ``__call__`` on the densified stack, without any (m, d) array."""
        raise NotImplementedError(
            f"{self.name!r} has no sparse-domain path — densify first"
        )

    def __repr__(self):
        return f"{type(self).__name__}({self.spec!r})"


class Mean(Aggregator):
    """Plain average — the non-robust contrast the paper draws."""

    supports_sparse = True

    def __init__(self):
        self.spec = self.name = "mean"

    def __call__(self, updates):
        return _agg.mean(updates), torch.ones(
            updates.shape[0], dtype=updates.dtype, device=updates.device)

    def sparse(self, vals, idx, d):
        m = vals.shape[0]
        agg = aggregate_sparse(vals, idx, d) / m
        return agg, torch.ones(m, dtype=agg.dtype, device=agg.device)

    def check_resilience(self, alpha, m):
        return ("'mean' has no Byzantine tolerance — it is the "
                "deliberate non-robust baseline")


class NormTrim(Aggregator):
    """Paper's norm-based thresholding; resilient for α < β."""

    supports_sparse = True

    def __init__(self, beta: float):
        if not 0.0 < beta < 1.0:
            raise SpecError(
                f"norm_trim needs a trim fraction β in (0, 1), got {beta!r}; "
                f"use e.g. 'norm_trim:0.25' (β = 0 is just 'mean')"
            )
        self.beta = float(beta)
        self.spec = f"norm_trim:{self.beta!r}"
        self.name = "norm_trim"

    def __call__(self, updates):
        return _agg.norm_trim(updates, self.beta)

    def sparse(self, vals, idx, d):
        # with distinct indices per worker the payload norm IS the dense
        # update's norm, so the keep mask is the dense rule's; the kept
        # payloads then scatter-sum directly
        m = vals.shape[0]
        v32 = vals.to(torch.float32)
        keep, n_keep = _agg.norm_trim_keep(
            torch.linalg.vector_norm(v32, dim=1), self.beta)
        agg = aggregate_sparse(v32, idx, d, weights=keep) / n_keep
        return agg, keep.to(vals.dtype)

    def check_resilience(self, alpha, m):
        # β > α precondition: strictly more must be trimmed than corrupted
        if self.beta <= alpha:
            return (f"norm_trim β={self.beta!r} ≤ α={alpha!r}: the "
                    f"resilience precondition needs β > α — raise β (the "
                    f"paper uses β = α + 2/m = {alpha + 2 / m:.4g})")
        return None


def _num(head: str, arg: str, cast, what: str):
    try:
        return cast(arg)
    except ValueError:
        raise SpecError(
            f"aggregator spec {head!r} takes {what}, got {arg!r}"
        ) from None


def make_aggregator(spec) -> Aggregator:
    """Resolve a spec string (or pass through an Aggregator instance)."""
    if isinstance(spec, Aggregator):
        return spec
    if not isinstance(spec, str):
        raise SpecError(f"aggregator spec must be a string, got {spec!r}")
    head, _, arg = spec.partition(":")
    if head == "mean":
        return Mean()
    if head == "norm_trim":
        return NormTrim(_num(head, arg or "0.2", float, "a β fraction"))
    if head in _LATER:
        raise not_ported(f"aggregator {spec!r}", "Queue 1b item B1")
    raise SpecError(
        f"unknown aggregator spec {spec!r}; expected one of {AGGREGATOR_SPECS}"
    )


def default_aggregator_spec(beta: float) -> str:
    """The legacy β-field behaviour as a spec: norm_trim(β) when β > 0,
    plain mean otherwise."""
    return f"norm_trim:{float(beta)!r}" if beta > 0 else "mean"
