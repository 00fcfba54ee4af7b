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
  reference's Pallas ``krum_scores_fused``: tiled pair distances over the
  upper triangle, split over d (:func:`krum_plan`), then one CTA a row
  ranks its distances; only the (m,) scores leave the wrapper, and
  :func:`krum_select_fused` takes their argmin in PyTorch.
* The per-coordinate worker sort (:func:`sort_workers`,
  ``csrc/sort_workers.cu``), replacing the reference's Pallas
  ``sort_workers_fused``: a CTA loads a tile of columns once
  (:func:`sort_plan`) and sorts unique 64-bit keys on chip; the
  trimmed-mean and median epilogues of the reference run on top
  (:func:`trimmed_mean_fused`, :func:`coordinate_median_fused`).

Each kernel wrapper launches its kernel on a CUDA tensor, or raises; on a
CPU tensor it runs its plain version (``*_plain``), at any m.  On the card
krum and the sort serve m ≤ :data:`KRUM_MAX_M` and :data:`SORT_MAX_M`
(16384, 64× the reference's ``DENSE_FUSED_MAX_M``), the bound of a row or a
column held in a block's shared memory, and raise above it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from . import _build
from ._build import SMEM_PER_BLOCK, SMS

SPARSE_SCATTER_MAX_D = 4096
# krum_select's diagonal: the self-distance never counts as a neighbour
_BIG = 1e30
#: the largest m each kernel serves on the card: a column (sort) or a row
#: of d2 (krum) of 16384 keys and values fills 192 KB of shared memory
SORT_MAX_M = 16384
KRUM_MAX_M = 16384
#: krum's pair kernel stages this many columns at a time, in this many
#: slots, by tile; its select kernel loads this many partial sums a thread
#: at once
KRUM_CHUNK = {32: 64, 64: 32}
KRUM_STAGES = {32: 3, 64: 4}
KRUM_BATCH = 16
#: krum's select ranks a row by counting up to this m, by a sorting network
#: beyond
KRUM_RANK_MAX = 64
#: krum's split over d: the pair CTAs an SM holds at once by tile (T = 32:
#: 64 registers and 48 KB a CTA; T = 64: 80 registers and 64 KB), at most
#: this many waves of them, slices of at least this many columns, and
#: (S, m, m) scratch within this many bytes
KRUM_CTAS_PER_SM = {32: 4, 64: 3}
KRUM_WAVES = 4
KRUM_MIN_SLICE = 256
KRUM_SCRATCH_MAX = 1 << 28
#: the plain krum's (rows, rows, d) differences are made in blocks of at
#: most this many floats (1 GB)
KRUM_PLAIN_BLOCK = 1 << 28


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


@dataclass(frozen=True)
class KrumPlan:
    """How :func:`krum_scores` lays out its launches on the card.  Pair
    kernel: ``tile`` × ``tile`` tiles of d2 with i ≤ j (``tiles`` of them,
    in the order of :func:`krum_tiles`), times ``slices`` slices of
    ``chunks_per_slice`` chunks of :data:`KRUM_CHUNK` columns
    (:func:`krum_slices`); 256 threads and ``pair_smem`` bytes a CTA, and
    ``scratch_bytes`` of (slices, m, m) partial sums (0 when one slice
    writes d2 itself).  Select kernel: one CTA of ``select_threads`` a row,
    ``select_smem`` bytes; or, ``fused`` (one tile, one slice), none: the
    pair CTA ranks d2 itself."""
    m: int
    d: int
    tile: int
    tiles: int
    slices: int
    chunks_per_slice: int
    pair_smem: int
    scratch_bytes: int
    fused: bool
    select_threads: int
    select_smem: int

    @property
    def ctas(self) -> int:
        """CTAs of the pair kernel."""
        return self.tiles * self.slices


def _pad_pow2(m: int) -> int:
    return max(2, 1 << (m - 1).bit_length())


def _krum_split(m: int, d: int, tile: int):
    """(tiles, slices, chunks a slice) of the pair kernel at this tile: the
    split over d fills whole waves of the CTAs the card holds at once, up
    to :data:`KRUM_WAVES` of them (short CTAs balance diagonal tiles, which
    do half the work, against the others)."""
    nt = -(-m // tile)
    tiles = nt * (nt + 1) // 2
    nchunks = -(-d // KRUM_CHUNK[tile])
    held = KRUM_CTAS_PER_SM[tile] * SMS
    slices = 1
    if tiles < held:
        cap = min(max(1, d // KRUM_MIN_SLICE),
                  max(1, KRUM_SCRATCH_MAX // (4 * m * m)))
        waves = max(1, min(KRUM_WAVES, cap * tiles // held))
        slices = max(1, min(cap, waves * held // tiles))
    cps = -(-nchunks // slices)
    return tiles, (-(-nchunks // cps) if cps else 1), cps


def krum_plan(m: int, d: int) -> KrumPlan:
    """The launch plan of ``csrc/krum_scores.cu`` for an (m, d) stack.  The
    split S over d only where the tiles alone leave the card short of a
    wave (:func:`_krum_split`), each slice at least :data:`KRUM_MIN_SLICE`
    columns and the scratch within :data:`KRUM_SCRATCH_MAX` (S = 1 at the
    paper's (20, 300)).  Tiles of 64 where they still give two CTAs a
    multiprocessor (half the staging and L2 re-reads of 32), else 32.
    Raises above :data:`KRUM_MAX_M`."""
    if m < 1 or d < 0:
        raise ValueError(f"krum_plan needs m ≥ 1 and d ≥ 0, got m={m}, d={d}")
    if m > KRUM_MAX_M:
        raise ValueError(
            f"krum_scores' kernel serves m ≤ {KRUM_MAX_M} workers (a row of "
            f"d2 in one block's shared memory), got m={m}")
    tile = 64
    tiles, slices, cps = _krum_split(m, d, tile)
    if tiles * slices < 2 * SMS:
        tile = 32
        tiles, slices, cps = _krum_split(m, d, tile)
    P = _pad_pow2(m)
    fused = tiles == 1 and slices == 1
    threads = 0 if fused else min(max(P // 2, 256), 1024)
    return KrumPlan(
        m=m, d=d, tile=tile, tiles=tiles, slices=slices, chunks_per_slice=cps,
        pair_smem=4 * KRUM_STAGES[tile] * 2 * KRUM_CHUNK[tile] * tile,
        scratch_bytes=4 * slices * m * m if slices > 1 else 0, fused=fused,
        select_threads=threads,
        select_smem=0 if fused else (
            8 * P + 4 * (-(-m // 4) * 4)
            + 4 * max(threads * KRUM_BATCH if slices > 1 else 0,
                      m if m <= KRUM_RANK_MAX else 0)))


def krum_tiles(plan: KrumPlan):
    """(i0, j0) of each pair-kernel tile, in the order of its block index:
    (0, 0), (0, 1), (1, 1), (0, 2), ...  The tiles with i0 = j0 cover their
    pairs with i ≤ j."""
    out = []
    for t in range(plan.tiles):
        tj = (math.isqrt(8 * t + 1) - 1) // 2
        ti = t - tj * (tj + 1) // 2
        out.append((ti * plan.tile, tj * plan.tile))
    return out


def krum_slices(plan: KrumPlan):
    """The [begin, end) columns of each slice of the d split."""
    step = plan.chunks_per_slice * KRUM_CHUNK[plan.tile]
    return [(s * step, min((s + 1) * step, plan.d))
            for s in range(plan.slices)]


def _krum_d2_plain(flat: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances, the registry's math
    ``((x_i − x_j)²).sum(-1)``, made in blocks of rows and partners of at
    most :data:`KRUM_PLAIN_BLOCK` differences, so that a model-scale stack
    does not build its whole (m, m, d) tensor."""
    m, d = flat.shape
    per = max(1, KRUM_PLAIN_BLOCK // max(d, 1))
    bj = min(m, per)
    bi = max(1, per // bj)
    d2 = torch.empty((m, m), dtype=flat.dtype, device=flat.device)
    for i in range(0, m, bi):
        for j in range(0, m, bj):
            d2[i:i + bi, j:j + bj] = ((flat[i:i + bi, None, :]
                                       - flat[None, j:j + bj, :]) ** 2).sum(-1)
    return d2


def krum_scores_plain(flat: torch.Tensor, n_byz: int) -> torch.Tensor:
    """Plain PyTorch krum scores, the registry's math: pairwise squared
    distances, +1e30 on the diagonal, the sum of each row's k nearest."""
    m = flat.shape[0]
    d2 = _krum_d2_plain(flat)
    d2 = d2 + torch.eye(m, dtype=d2.dtype, device=d2.device) * _BIG
    k = krum_k_near(m, n_byz)
    return torch.sort(d2, dim=1).values[:, :k].sum(1)


def _krum_launch(flat: torch.Tensor, n_byz: int):
    """Launch ``csrc/krum_scores.cu`` on a CUDA stack: the (m,) scores and
    the (m, m) d2 they were ranked from (its diagonal +1e30)."""
    m, d = flat.shape
    plan = krum_plan(m, d)
    dev = flat.device
    scores = torch.empty((m,), dtype=torch.float32, device=dev)
    d2 = torch.empty((m, m), dtype=torch.float32, device=dev)
    part = (torch.empty((plan.slices, m, m), dtype=torch.float32, device=dev)
            if plan.slices > 1 else d2)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("krum_scores", flat.data_ptr(), part.data_ptr(),
                      d2.data_ptr(), scores.data_ptr(), m, d,
                      krum_k_near(m, n_byz), plan.tile, plan.slices,
                      plan.chunks_per_slice, stream)
    return scores, d2


def krum_scores(flat: torch.Tensor, n_byz: int) -> torch.Tensor:
    """(m,) krum scores of an (m, d) float32 stack: the kernel on a CUDA
    tensor (m ≤ :data:`KRUM_MAX_M`), the plain version on a CPU one."""
    _check_stack(flat, "krum_scores")
    if n_byz < 0:
        raise ValueError(f"krum_scores needs n_byz ≥ 0, got {n_byz}")
    if flat.device.type == "cpu":
        return krum_scores_plain(flat, n_byz)
    return _krum_launch(flat, n_byz)[0]


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


@dataclass(frozen=True)
class SortPlan:
    """How :func:`sort_workers` lays out its launch on the card: rows padded
    to ``pad`` (a power of two), ``per_thread`` keys a thread, ``lanes``
    threads a column; one CTA of ``threads`` sorts each of ``ctas`` tiles
    of ``tile`` columns, in ``smem_bytes`` of shared memory."""
    m: int
    d: int
    pad: int
    per_thread: int
    lanes: int
    tile: int
    threads: int
    smem_bytes: int

    @property
    def ctas(self) -> int:
        return -(-self.d // self.tile)


def sort_plan(m: int, d: int) -> SortPlan:
    """The launch plan of ``csrc/sort_workers.cu`` for an (m, d) stack: the
    tile is as wide as 256 threads allow (at least one column), and the
    (m, tile) slab plus, for columns wider than a warp, the column's key
    buffer fit a block's shared memory up to m = :data:`SORT_MAX_M`;
    raises above it."""
    if m < 1 or d < 0:
        raise ValueError(f"sort_plan needs m ≥ 1 and d ≥ 0, got m={m}, d={d}")
    if m > SORT_MAX_M:
        raise ValueError(
            f"sort_workers' kernel serves m ≤ {SORT_MAX_M} workers (a column "
            f"in one block's shared memory), got m={m}")
    pad = _pad_pow2(m)
    per = pad if pad <= 16 else (16 if pad < 4096 else 32)
    lanes = pad // per
    tile = max(256, lanes) // lanes
    smem = 4 * (-(-m * tile // 32) * 32) + (8 * pad * tile if lanes > 32
                                             else 0)
    return SortPlan(m=m, d=d, pad=pad, per_thread=per, lanes=lanes,
                    tile=tile, threads=tile * lanes, smem_bytes=smem)


def sort_workers(updates: torch.Tensor) -> torch.Tensor:
    """Ascending sort of every coordinate of an (m, d) float32 stack over
    the workers: the kernel on a CUDA tensor (m ≤ :data:`SORT_MAX_M`), the
    plain version on a CPU one.  Both give the same bits."""
    m, d = _check_stack(updates, "sort_workers")
    if updates.device.type == "cpu":
        return sort_workers_plain(updates)
    plan = sort_plan(m, d)
    out = torch.empty_like(updates)
    with torch.cuda.device(updates.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("sort_workers", updates.data_ptr(), out.data_ptr(), m,
                      d, plan.tile, stream)
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
