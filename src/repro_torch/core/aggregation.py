"""Robust aggregation rules at the center (the math layer of
:mod:`repro_torch.api.aggregators`).

The paper's rule (Algorithm 1, step 6) is **norm-based thresholding**:
sort workers by ‖s_i‖, keep the smallest ``(1−β)m``, average the
survivors.  The baselines it is compared with are the coordinate-wise
median and trimmed mean ByzantinePGD uses, and krum.  Updates are stacked
on a leading worker axis, ``(m, d)``.  These are the plain versions; the
``*_kernel`` heads of :mod:`repro_torch.api.aggregators` run the same math
on the kernels of :mod:`repro_torch.kernels.robust_agg`.  The reference's
``*_tree`` variants belong to the mesh runtime, which is not ported yet.
"""
from __future__ import annotations

import torch

from .._device import div_exact
from ..kernels.robust_agg import (
    krum_scores_plain,
    median_of_sorted,
    sort_workers_plain,
    trimmed_mean_of_sorted,
)


def mean(updates):
    return updates.mean(0)


def norm_trim_keep(norms, beta: float):
    """Keep mask of the ``(1−β)m`` smallest norms (ties broken by worker
    index, as the reference's stable argsort breaks them) and its size."""
    m = norms.shape[0]
    n_keep = max(1, int(round((1.0 - beta) * m)))
    order = torch.argsort(norms, stable=True)
    ranks = torch.argsort(order, stable=True)
    return (ranks < n_keep).to(norms.dtype), n_keep


def norm_trim(updates, beta: float):
    """Paper's rule: keep the ``(1-beta)m`` smallest-norm updates, average.
    Returns (aggregate, keep_mask)."""
    m = updates.shape[0]
    flat = updates.reshape(m, -1)
    keep, n_keep = norm_trim_keep(torch.linalg.vector_norm(flat, dim=1), beta)
    keep = keep.to(updates.dtype)
    agg = div_exact((keep[:, None] * flat).sum(0), n_keep)
    return agg.reshape(updates.shape[1:]), keep


def contribution_keep(updates, lo: int, hi: int):
    """Soft keep mask of the coordinate-wise rules: the fraction of
    coordinates where each worker's value ranked inside ``[lo, hi)``, i.e.
    entered the trimmed-mean or median epilogue.  Ranks come from stable
    argsorts, so ties go by worker index, as ``jnp.argsort`` breaks them."""
    m = updates.shape[0]
    flat = updates.reshape(m, -1)
    order = torch.argsort(flat, dim=0, stable=True)
    ranks = torch.argsort(order, dim=0, stable=True)
    kept = (ranks >= lo) & (ranks < hi)
    # the count times 1/D, rounded as jnp.mean rounds it (count/D may
    # differ in the last bit)
    return kept.to(torch.float32).sum(1) * (1.0 / flat.shape[1])


def coordinate_median(updates):
    """Coordinate-wise median, with ``jnp.median``'s midpoint for even m."""
    return median_of_sorted(sort_workers_plain(updates))


def trimmed_mean(updates, trim_frac: float):
    """Coordinate-wise trimmed mean: drop the top and bottom
    ``round(trim_frac·m)`` values of each coordinate (at most (m − 1)//2),
    average the rest."""
    return trimmed_mean_of_sorted(sort_workers_plain(updates), trim_frac)


def krum_select(flat, n_byz: int):
    """Krum's selected worker (a 0-d index tensor) for an (m, D) stack: the
    update whose summed squared distance to its max(m − f − 2, 1) nearest
    others is smallest; the first one on a tie, as ``jnp.argmin`` picks."""
    return torch.argmin(krum_scores_plain(flat, n_byz))
