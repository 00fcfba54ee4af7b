"""The center's aggregation kernels.

* Sparse-domain aggregation (:func:`aggregate_sparse`): Σᵢ wᵢ·scatter(valsᵢ,
  idxᵢ) over m top-k wire payloads, never building an (m, d) array, bit for
  bit the sequential contract of ``kernels/ref.py::sparse_aggregate_ref``
  (:func:`aggregate_sparse_plain`).  On a CUDA tensor it launches
  ``csrc/sparse_agg.cu`` (:func:`aggregate_sparse_gridded`, replacing the
  reference's Pallas ``aggregate_sparse_gridded``) at every d, in one
  launch: CUDA's ``index_add_`` sums duplicate coordinates in no fixed
  order, so the reference's scatter branch up to
  :data:`SPARSE_SCATTER_MAX_D` would not repeat its bits from run to run.
  The kernel moves few bytes, so latency bounds it: each CTA owns a range
  of coordinates, loads the payload a chunk at a time and orders each
  chunk through a shared-memory table of (row, coordinate), with no sort
  and no order-dependent atomics.  On a CPU tensor it keeps the
  reference's boundary (:func:`agg_kernel_plan`): ``index_add_``, which
  sums in stream order there, up to it, and the plain version beyond.
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


def agg_kernel_plan(m: int, d: int, *, k: int) -> str:
    """The reference's ``agg_kernel_plan`` boundary: ``"scatter"`` up to
    :data:`SPARSE_SCATTER_MAX_D`, ``"sparse_gridded"`` beyond.  It chooses
    the path of a CPU tensor only; on the card every d takes the kernel."""
    if m < 1 or k < 0 or d < 1:
        raise ValueError(f"sparse aggregation needs m >= 1, k >= 0 and "
                         f"d >= 1, got m={m}, k={k}, d={d}")
    return "scatter" if d <= SPARSE_SCATTER_MAX_D else "sparse_gridded"


def _weighted(vals, weights):
    """The payload values with each worker's weight folded in (one f32
    rounding per value), as the contract has it."""
    v = vals.to(torch.float32)
    if weights is not None:
        v = v * weights.to(torch.float32)[:, None]
    return v


def aggregate_sparse_plain(vals, idx, d: int, weights=None):
    """Plain PyTorch version of the contract of ``sparse_aggregate_ref``: the
    weighted payloads ravel into one stream, a stable sort by coordinate
    keeps worker order and then row order among duplicates, and every
    coordinate adds its entries to 0.0 in that order.  The j-th entries of
    all coordinates are added in one pass, so each pass writes distinct
    coordinates and the result is the same on any device."""
    vs = _weighted(vals, weights).reshape(-1)
    ix, order = torch.sort(idx.reshape(-1).long(), stable=True)
    vs = vs[order]
    rank = (torch.arange(ix.numel(), device=ix.device)
            - torch.searchsorted(ix, ix, side="left"))
    out = torch.zeros((d,), dtype=torch.float32, device=vals.device)
    for j in range(int(rank.max()) + 1 if ix.numel() else 0):
        sel = rank == j
        c = ix[sel]
        out[c] = out[c] + vs[sel]
    return out


def _check_payload(vals, idx, weights):
    if vals.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"sparse aggregation takes float32 values and int32 "
                        f"indices, got {vals.dtype} and {idx.dtype}")
    if vals.dim() != 2 or idx.shape != vals.shape:
        raise ValueError(f"sparse aggregation takes (m, k) values and "
                         f"indices, got {tuple(vals.shape)} and "
                         f"{tuple(idx.shape)}")
    if weights is not None and tuple(weights.shape) != (vals.shape[0],):
        raise ValueError(f"sparse aggregation takes (m,) weights, got "
                         f"{tuple(weights.shape)}")
    for t in (idx, weights):
        if t is not None and t.device != vals.device:
            raise ValueError(f"sparse aggregation: payloads on "
                             f"{vals.device}, another input on {t.device}")
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sparse aggregation runs on cuda or cpu, got "
                         f"{vals.device}")


def _aligned(t):
    """``t`` contiguous and 16-byte aligned (the kernel's vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def aggregate_sparse_gridded(vals, idx, d: int, weights=None):
    """values (m, k) f32 + indices (m, k) int32 (+ optional weights (m,))
    → the (d,) f32 weighted sum, bit for bit the contract's: on a CUDA
    tensor one launch of ``csrc/sparse_agg.cu`` (any d, rows in any order);
    on a CPU tensor :func:`aggregate_sparse_plain`.  Indices must lie in
    [0, d): the kernel sums no entry outside it (the plain version raises on
    one)."""
    _check_payload(vals, idx, weights)
    if vals.device.type == "cpu":
        return aggregate_sparse_plain(vals, idx, d, weights)
    m, k = vals.shape
    vals, idx = _aligned(vals), _aligned(idx)
    w = None if weights is None else weights.to(torch.float32).contiguous()
    out = torch.empty((d,), dtype=torch.float32, device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("sparse_agg", vals.data_ptr(), idx.data_ptr(),
                      None if w is None else w.data_ptr(), out.data_ptr(),
                      m, k, d, stream)
    return out


def aggregate_sparse(vals, idx, d: int, weights=None):
    """values (m, k) f32 + indices (m, k) int32 (+ optional weights (m,))
    → the (d,) f32 weighted sum of the scattered payloads, bit for bit
    :func:`aggregate_sparse_plain`: on a CUDA tensor the kernel
    (:func:`aggregate_sparse_gridded`) at every d; on a CPU tensor the path
    :func:`agg_kernel_plan` picks, ``index_add_`` (stream order on the CPU)
    up to :data:`SPARSE_SCATTER_MAX_D` and the plain version beyond."""
    m, k = vals.shape
    plan = agg_kernel_plan(m, d, k=k)
    if vals.device.type == "cuda" or plan == "sparse_gridded":
        return aggregate_sparse_gridded(vals, idx, d, weights)
    v = _weighted(vals, weights)
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
