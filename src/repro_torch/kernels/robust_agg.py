"""Sparse-domain aggregation at the center: Σᵢ wᵢ·scatter(valsᵢ, idxᵢ)
over m top-k wire payloads, never building an (m, d) array.

The reference (``kernels/robust_agg.py::aggregate_sparse``) takes a plain
``jnp`` scatter-add up to :data:`SPARSE_SCATTER_MAX_D` and its gridded
Pallas segmented-merge kernel (``aggregate_sparse_gridded``) beyond.  The
scatter branch is ported here as ``index_add_``; the gridded kernel is not
ported yet, so above the bound this raises rather than quietly scattering.
"""
from __future__ import annotations

import torch

SPARSE_SCATTER_MAX_D = 4096


def aggregate_sparse(vals, idx, d: int, weights=None):
    """values (m, k) f32 + indices (m, k) int32 (+ optional weights (m,))
    → the (d,) f32 weighted sum of the scattered payloads."""
    if d > SPARSE_SCATTER_MAX_D:
        raise NotImplementedError(
            f"sparse aggregation at d={d} > {SPARSE_SCATTER_MAX_D} runs the "
            f"reference's gridded Pallas kernel (aggregate_sparse_gridded), "
            f"which is not ported yet -- ROADMAP.md Queue 2 item 3"
        )
    v = vals.to(torch.float32)
    if weights is not None:
        v = v * weights.to(torch.float32)[:, None]
    out = torch.zeros((d,), dtype=torch.float32, device=vals.device)
    return out.index_add_(0, idx.reshape(-1).long(), v.reshape(-1))
