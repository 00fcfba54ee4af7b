"""Aggregator registry: spec strings → resolved :class:`Aggregator`.

The port of the reference's ``api/aggregators.py`` for the paper runtime:

    "mean"                  plain average (non-robust reference)
    "norm_trim:0.25"        paper's rule — drop the β·m largest-norm
                            updates, average the rest (β ∈ (0, 1))
    "krum:2"                Krum [BMGS17] assuming n_byz Byzantine workers
    "trimmed_mean:0.1"      coordinate-wise trimmed mean (ByzantinePGD's
                            default), trim_frac per side
    "coordinate_median"     coordinate-wise median

and the kernel heads, the same math on the Hopper kernels of
:mod:`repro_torch.kernels.robust_agg`:

    "krum_kernel:2"             pairwise distances and scores in one launch
    "trimmed_mean_kernel:0.1"   per-coordinate worker sort
    "coordinate_median_kernel"  same sort, median epilogue

``agg(updates)`` takes the flat ``(m, d)`` stack and returns
``(aggregate (d,), keep mask (m,))``: 0/1 by rank for norm_trim, one-hot
for krum, and for the coordinate-wise rules the soft fraction of
coordinates each worker contributed to.  ``agg.sparse(vals, idx, d)`` does
the same on the top-k wire payloads without densifying them (mean and
norm_trim only).
"""
from __future__ import annotations

import torch

from .._device import div_exact
from ..core import aggregation as _agg
from ..kernels import (
    aggregate_sparse,
    coordinate_median_fused,
    krum_select_fused,
    trimmed_mean_fused,
)
from ..kernels.robust_agg import trim_count
from .errors import SpecError

AGGREGATOR_SPECS = ("mean", "norm_trim:<beta>", "krum:<n_byz>",
                    "trimmed_mean:<frac>", "coordinate_median",
                    "krum_kernel:<n_byz>", "trimmed_mean_kernel:<frac>",
                    "coordinate_median_kernel")


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
        agg = div_exact(aggregate_sparse(vals, idx, d), m)
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
        agg = div_exact(aggregate_sparse(v32, idx, d, weights=keep), n_keep)
        return agg, keep.to(vals.dtype)

    def check_resilience(self, alpha, m):
        # β > α precondition: strictly more must be trimmed than corrupted
        if self.beta <= alpha:
            return (f"norm_trim β={self.beta!r} ≤ α={alpha!r}: the "
                    f"resilience precondition needs β > α — raise β (the "
                    f"paper uses β = α + 2/m = {alpha + 2 / m:.4g})")
        return None


class Krum(Aggregator):
    """Krum [BMGS17]: forward the single most-central update.

    ``use_kernel=True`` (spec head ``krum_kernel``) scores the flat stack
    with :func:`repro_torch.kernels.krum_select_fused`, the plain head with
    :func:`repro_torch.core.aggregation.krum_select`."""

    def __init__(self, n_byz: int, use_kernel: bool = False):
        if n_byz < 0:
            raise SpecError(f"krum needs n_byz ≥ 0, got {n_byz}")
        self.n_byz = int(n_byz)
        self.use_kernel = bool(use_kernel)
        self.name = "krum_kernel" if use_kernel else "krum"
        self.spec = f"{self.name}:{self.n_byz}"

    def __call__(self, updates):
        m = updates.shape[0]
        flat = updates.reshape(m, -1).to(torch.float32).contiguous()
        select = krum_select_fused if self.use_kernel else _agg.krum_select
        j = select(flat, self.n_byz)
        keep = (torch.arange(m, device=updates.device) == j).to(
            updates.dtype)
        return updates[j], keep

    def check_resilience(self, alpha, m):
        f = int(alpha * m)  # byzantine_mask's worker count
        if self.n_byz < f:
            return (f"krum:{self.n_byz} assumes fewer Byzantine workers "
                    f"than α={alpha!r} implies at m={m} — raise n_byz "
                    f"to ≥ {f}")
        if m < 2 * self.n_byz + 3:
            return (f"krum needs m ≥ 2·n_byz + 3 = {2 * self.n_byz + 3} "
                    f"workers to score n_byz={self.n_byz}, got m={m}")
        return None


class TrimmedMean(Aggregator):
    """Coordinate-wise trimmed mean (ByzantinePGD's default).

    ``use_kernel=True`` (spec head ``trimmed_mean_kernel``) sorts with
    :func:`repro_torch.kernels.sort_workers`; the epilogue is the same."""

    def __init__(self, trim_frac: float, use_kernel: bool = False):
        if not 0.0 < trim_frac < 0.5:
            raise SpecError(
                f"trimmed_mean needs a per-side trim fraction in (0, 0.5), "
                f"got {trim_frac!r}; use e.g. 'trimmed_mean:0.1'"
            )
        self.trim_frac = float(trim_frac)
        self.use_kernel = bool(use_kernel)
        self.name = "trimmed_mean_kernel" if use_kernel else "trimmed_mean"
        self.spec = f"{self.name}:{self.trim_frac!r}"

    def __call__(self, updates):
        m = updates.shape[0]
        if self.use_kernel:
            agg = trimmed_mean_fused(updates.contiguous(), self.trim_frac)
        else:
            agg = _agg.trimmed_mean(updates, self.trim_frac)
        # soft keep: the fraction of coordinates each worker contributed
        # to (0 = trimmed away everywhere)
        k = trim_count(m, self.trim_frac)
        keep = (torch.ones(m, dtype=updates.dtype, device=updates.device)
                if k == 0 else
                _agg.contribution_keep(updates, k, m - k).to(updates.dtype))
        return agg.to(updates.dtype), keep

    def check_resilience(self, alpha, m):
        # per-coordinate: the values cut per side must cover every
        # corrupted worker
        k = trim_count(m, self.trim_frac)
        f = int(alpha * m)
        if k < f:
            return (f"trimmed_mean:{self.trim_frac!r} cuts {k}/side at "
                    f"m={m} but α={alpha!r} corrupts {f} workers — raise "
                    f"the trim fraction to ≥ {f / m:.4g}")
        return None


class CoordinateMedian(Aggregator):
    """Coordinate-wise median; resilient up to α < 1/2.

    ``use_kernel=True`` (spec head ``coordinate_median_kernel``) sorts with
    :func:`repro_torch.kernels.sort_workers`; the epilogue is the same."""

    def __init__(self, use_kernel: bool = False):
        self.use_kernel = bool(use_kernel)
        self.spec = self.name = (
            "coordinate_median_kernel" if use_kernel else "coordinate_median"
        )

    def __call__(self, updates):
        m = updates.shape[0]
        if self.use_kernel:
            agg = coordinate_median_fused(updates.contiguous())
        else:
            agg = _agg.coordinate_median(updates)
        # soft keep: the fraction of coordinates where the worker's value
        # was a median contributor (the middle rank, or both for even m)
        keep = _agg.contribution_keep(updates, (m - 1) // 2, m // 2 + 1)
        return agg.to(updates.dtype), keep.to(updates.dtype)

    def check_resilience(self, alpha, m):
        if int(alpha * m) > (m - 1) // 2:
            return (f"coordinate_median needs an honest majority: "
                    f"α={alpha!r} corrupts {int(alpha * m)} of m={m}")
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
    if head in ("krum", "krum_kernel"):
        return Krum(_num(head, arg or "2", int, "an integer n_byz"),
                    use_kernel=head == "krum_kernel")
    if head in ("trimmed_mean", "trimmed_mean_kernel"):
        return TrimmedMean(_num(head, arg or "0.2", float, "a trim fraction"),
                           use_kernel=head == "trimmed_mean_kernel")
    if head in ("coordinate_median", "coordinate_median_kernel"):
        return CoordinateMedian(use_kernel=head == "coordinate_median_kernel")
    raise SpecError(
        f"unknown aggregator spec {spec!r}; expected one of {AGGREGATOR_SPECS}"
    )


def default_aggregator_spec(beta: float) -> str:
    """The legacy β-field behaviour as a spec: norm_trim(β) when β > 0,
    plain mean otherwise."""
    return f"norm_trim:{float(beta)!r}" if beta > 0 else "mean"
