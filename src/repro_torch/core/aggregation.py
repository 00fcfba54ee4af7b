"""Robust aggregation rules at the center (the math layer of
:mod:`repro_torch.api.aggregators`).

The paper's rule (Algorithm 1, step 6) is **norm-based thresholding**:
sort workers by ‖s_i‖, keep the smallest ``(1−β)m``, average the
survivors.  Updates are stacked on a leading worker axis, ``(m, d)``.
The reference's other rules (coordinate-wise median, trimmed mean, krum)
are a later slice of the port.
"""
from __future__ import annotations

import torch


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
    agg = (keep[:, None] * flat).sum(0) / n_keep
    return agg.reshape(updates.shape[1:]), keep
