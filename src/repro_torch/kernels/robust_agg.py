"""The center's aggregation kernels.

* Sparse-domain aggregation: Σᵢ wᵢ·scatter(valsᵢ, idxᵢ) over m top-k wire
  payloads, never building an (m, d) array.  The reference
  (``kernels/robust_agg.py::aggregate_sparse``) takes a plain ``jnp``
  scatter-add up to :data:`SPARSE_SCATTER_MAX_D` and its gridded Pallas
  segmented-merge kernel (``aggregate_sparse_gridded``) beyond.  The scatter
  branch is ported here as ``index_add_``; the gridded kernel is not ported
  yet, so above the bound this raises rather than quietly scattering.
* Krum scores (:func:`krum_scores`, ``csrc/krum_scores.cu``), replacing the
  reference's Pallas ``krum_scores_fused``: only the (m,) scores leave the
  kernel, and :func:`krum_select_fused` takes their argmin in PyTorch.
* The per-coordinate worker sort (:func:`sort_workers`,
  ``csrc/sort_workers.cu``), replacing the reference's Pallas
  ``sort_workers_fused``, with the trimmed-mean and median epilogues of the
  reference run on top (:func:`trimmed_mean_fused`,
  :func:`coordinate_median_fused`).

Each kernel wrapper launches its kernel on a CUDA tensor, or raises; on a
CPU tensor it runs its plain version (``*_plain``).  Unlike the reference,
the wrappers serve every m: the reference's ``DENSE_FUSED_MAX_M`` is a
bound of its on-chip (P, P) tile, and these kernels keep no such tile.
"""
from __future__ import annotations

import torch

from . import _build

SPARSE_SCATTER_MAX_D = 4096
# krum_select's diagonal: the self-distance never counts as a neighbour
_BIG = 1e30


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


def _check_stack(x: torch.Tensor, what: str):
    """(m, d) of a float32 stack the kernels take; raise on anything else."""
    if x.dtype != torch.float32:
        raise TypeError(f"{what} takes float32, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"{what} takes an (m, d) stack with m ≥ 1, got "
                         f"{tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, got {x.device}")
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous tensor")
    return x.shape


def krum_k_near(m: int, n_byz: int) -> int:
    """How many nearest neighbours a krum score sums: max(m − f − 2, 1)."""
    return max(m - int(n_byz) - 2, 1)


def krum_scores_plain(flat: torch.Tensor, n_byz: int) -> torch.Tensor:
    """Plain PyTorch krum scores, the registry's math: pairwise squared
    distances, +1e30 on the diagonal, the sum of each row's k nearest."""
    m = flat.shape[0]
    d2 = ((flat[:, None, :] - flat[None, :, :]) ** 2).sum(-1)
    d2 = d2 + torch.eye(m, dtype=d2.dtype, device=d2.device) * _BIG
    k = krum_k_near(m, n_byz)
    return torch.sort(d2, dim=1).values[:, :k].sum(1)


def krum_scores(flat: torch.Tensor, n_byz: int) -> torch.Tensor:
    """(m,) krum scores of an (m, d) float32 stack: the kernel on a CUDA
    tensor, the plain version on a CPU one."""
    m, d = _check_stack(flat, "krum_scores")
    if n_byz < 0:
        raise ValueError(f"krum_scores needs n_byz ≥ 0, got {n_byz}")
    if flat.device.type == "cpu":
        return krum_scores_plain(flat, n_byz)
    k = krum_k_near(m, n_byz)
    dev = flat.device
    scores = torch.empty((m,), dtype=torch.float32, device=dev)
    d2 = torch.empty((m, m), dtype=torch.float32, device=dev)
    sel = torch.empty((m, k), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("krum_scores", flat.data_ptr(), d2.data_ptr(),
                      sel.data_ptr(), scores.data_ptr(), m, d, k, stream)
    return scores


def krum_select_fused(flat: torch.Tensor, n_byz: int) -> torch.Tensor:
    """Index (a 0-d tensor) of the worker with the smallest krum score,
    from :func:`krum_scores`; ``argmin`` returns the first minimum, as
    ``jnp.argmin`` does."""
    return torch.argmin(krum_scores(flat, n_byz))


def sort_workers_plain(updates: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch per-coordinate sort over the workers: stable, so equal
    values (±0 among them) keep their worker order, as ``jnp.sort`` keeps
    it; NaN sorts last."""
    return torch.sort(updates, dim=0, stable=True).values


def sort_workers(updates: torch.Tensor) -> torch.Tensor:
    """Ascending sort of every coordinate of an (m, d) float32 stack over
    the workers: the kernel on a CUDA tensor, the plain version on a CPU
    one.  Both give the same bits."""
    m, d = _check_stack(updates, "sort_workers")
    if updates.device.type == "cpu":
        return sort_workers_plain(updates)
    out = torch.empty_like(updates)
    with torch.cuda.device(updates.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("sort_workers", updates.data_ptr(), out.data_ptr(), m,
                      d, stream)
    return out


def trim_count(m: int, trim_frac: float) -> int:
    """Values cut per side by the trimmed mean: round(frac·m), at most
    (m − 1)//2 so that one value stays."""
    return min(int(round(trim_frac * m)), (m - 1) // 2)


def trimmed_mean_of_sorted(srt: torch.Tensor, trim_frac: float):
    """The reference's trimmed-mean epilogue on a worker-sorted stack."""
    m = srt.shape[0]
    k = trim_count(m, trim_frac)
    return (srt if k == 0 else srt[k:m - k]).mean(0)


def median_of_sorted(srt: torch.Tensor):
    """The middle row of a worker-sorted stack, or for even m the midpoint
    (low + high)·0.5 of the two middle rows, as ``jnp.median`` takes it
    (``torch.median`` would return the lower one)."""
    m = srt.shape[0]
    if m % 2:
        return srt[m // 2]
    return (srt[m // 2 - 1] + srt[m // 2]) * 0.5


def trimmed_mean_fused(updates: torch.Tensor, trim_frac: float):
    """Coordinate-wise trimmed mean on :func:`sort_workers`."""
    return trimmed_mean_of_sorted(sort_workers(updates), trim_frac)


def coordinate_median_fused(updates: torch.Tensor):
    """Coordinate-wise median on :func:`sort_workers`."""
    return median_of_sorted(sort_workers(updates))
