"""Top-|x| compression of a stack of sender rows: the wire payload of
:class:`repro_torch.compression.TopK`.

:func:`topk_compress` takes ``x`` of shape ``(m, d)`` (or ``(d,)``) and
returns the k largest-magnitude values of every row and their int32
indices, in ascending index order, ties at the threshold magnitude filled
lowest index first -- the contract of the reference's
``kernels/ref.py::topk_compress_ref`` (``lax.top_k``, then the indices
sorted), bit for bit.

* On a CUDA tensor it launches a hand-written kernel, one launch a call, or
  raises, chosen by d as the reference chooses its launch
  (:func:`kernel_plan`) and laid out by :func:`topk_plan`: up to
  :data:`SINGLE_TILE_MAX_D`, the bound of the reference's single-tile
  launch, ``csrc/topk_compress.cu`` (one warp a row, the select and the
  pack inside the warp); beyond it :func:`topk_compress_sharded` on
  ``csrc/topk_sharded.cu`` (a thread block cluster a row, its histograms
  summed in distributed shared memory; any d).  Neither needs scratch.
* On a CPU tensor it runs :func:`topk_compress_plain`, the plain PyTorch
  version of the same contract, at any d.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import _build
from ._build import SMS

SINGLE_TILE_MAX_D = 1408
#: the single-tile kernel's rows (one warp each) a CTA (``kWarps`` in
#: ``csrc/topk_compress.cu``)
TOPK_WARPS = 4
#: the cluster kernel's threads a CTA, and the cluster sizes it takes
TOPK_CLUSTER_THREADS = 512
TOPK_CLUSTER_SIZES = (1, 2, 4, 8, 16)
#: a row of up to TOPK_SLICE_ONE coordinates takes one CTA (no cluster
#: barrier); a wider one the smallest cluster whose slices hold at most
#: TOPK_SLICE_TARGET each, at most 8 CTAs while their slices stay within
#: TOPK_SLICE_WHOLE; then half of it while the stack's CTAs need more than
#: one wave of the card and the halved slices stay within TOPK_SLICE_WHOLE.
#: A slice of TOPK_SLICE_WHOLE coordinates (192 KB) stays whole in a CTA's
#: shared memory beside the kernel's histograms; of a wider one the kernel
#: keeps what fits (:func:`sharded_layout`) and re-reads the rest from L2
TOPK_SLICE_ONE = 8192
TOPK_SLICE_TARGET = 4096
TOPK_SLICE_WHOLE = 49152


@dataclass(frozen=True)
class TopkPlan:
    """The launch of one top-k call on the card: ``route``
    ``"single_tile"`` (a warp a row, ``warps`` rows a CTA) or ``"sharded"``
    (``cluster`` CTAs of ``warps`` warps a row, each owning ``slice``
    coordinates; what of it stays in shared memory, :func:`sharded_layout`
    says)."""
    m: int
    d: int
    route: str
    warps: int
    cluster: int
    slice: int

    @property
    def threads(self) -> int:
        return 32 * self.warps

    @property
    def ctas(self) -> int:
        if self.route == "single_tile":
            return -(-self.m // self.warps)
        return self.m * self.cluster


def topk_compress_plain(x: torch.Tensor, k: int):
    """Plain PyTorch top-|x|: a stable descending sort of |x| keeps the
    lowest index first among equal magnitudes (``torch.topk`` promises no
    tie order), the first k are taken, and the indices are sorted."""
    order = torch.sort(x.abs(), dim=-1, descending=True, stable=True).indices
    idx = torch.sort(order[..., :k], dim=-1).values
    return torch.gather(x, -1, idx), idx.to(torch.int32)


def _check(x: torch.Tensor, k: int) -> int:
    if x.dtype != torch.float32:
        raise TypeError(f"topk_compress takes float32, got {x.dtype}")
    if x.dim() not in (1, 2):
        raise ValueError(f"topk_compress takes (d,) or (m, d), got "
                         f"{tuple(x.shape)}")
    d = x.shape[-1]
    if not 1 <= k <= d:
        raise ValueError(f"topk_compress needs 1 <= k <= d, got k={k}, d={d}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"topk_compress runs on cuda or cpu, got {x.device}")
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError("topk_compress takes a contiguous tensor")
    return d


def kernel_plan(d: int) -> str:
    """Which launch serves a d-wide row: ``"single_tile"`` up to
    :data:`SINGLE_TILE_MAX_D`, ``"sharded"`` beyond (the reference's
    ``kernel_plan`` boundary)."""
    if d < 1:
        raise ValueError(f"top-k needs d >= 1, got {d}")
    return "single_tile" if d <= SINGLE_TILE_MAX_D else "sharded"


def _slice(d: int, c: int) -> int:
    """Coordinates a CTA of a cluster of c owns: ceil(d / c), rounded up
    to 4 (16-byte loads)."""
    per = -(-d // c)
    return -(-per // 4) * 4


@functools.lru_cache(maxsize=256)
def _cluster_plan(m: int, d: int) -> TopkPlan:
    """The cluster kernel's launch for an (m, d) stack (any d ≥ 1)."""
    sizes = TOPK_CLUSTER_SIZES
    c = 1
    if d > TOPK_SLICE_ONE:
        c = next((c for c in sizes if _slice(d, c) <= TOPK_SLICE_TARGET),
                 sizes[-1])
        if c > 8 and _slice(d, 8) <= TOPK_SLICE_WHOLE:
            c = 8
    while c > 1 and m * c > SMS and _slice(d, c // 2) <= TOPK_SLICE_WHOLE:
        c //= 2
    return TopkPlan(m=m, d=d, route="sharded",
                    warps=TOPK_CLUSTER_THREADS // 32, cluster=c,
                    slice=_slice(d, c))


@functools.lru_cache(maxsize=256)
def topk_plan(m: int, d: int) -> TopkPlan:
    """The launch :func:`topk_compress` makes for an (m, d) stack on the
    card, by :func:`kernel_plan`'s boundary: one warp a row,
    :data:`TOPK_WARPS` rows a CTA, up to :data:`SINGLE_TILE_MAX_D`; beyond
    it a cluster of CTAs a row, its size from d and m
    (:data:`TOPK_SLICE_ONE`, :data:`TOPK_SLICE_TARGET`,
    :data:`TOPK_SLICE_WHOLE`, one wave of :data:`SMS`)."""
    if m < 0:
        raise ValueError(f"topk_plan needs m >= 0, got {m}")
    if kernel_plan(d) == "sharded":
        return _cluster_plan(m, d)
    return TopkPlan(m=m, d=d, route="single_tile", warps=TOPK_WARPS,
                    cluster=1, slice=d)


@functools.lru_cache(maxsize=256)
def _layout(device_index: int, d: int, cluster: int):
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device_index):
        _build.query("topk_sharded_plan", d, cluster, out)
    return tuple(out)


def sharded_layout(d: int, cluster: int, *, device=None):
    """(slice, keep, smem_bytes) of the cluster kernel at width d and
    cluster size ``cluster`` on a card (the current one when ``device`` is
    None), as ``csrc/topk_sharded.cu`` lays it out: the coordinates a CTA
    owns, the first ``keep`` of them held in shared memory (all, or what
    fits the card's per-block limit beside the histograms), and a CTA's
    dynamic shared memory."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"sharded_layout reads a card, got {dev}")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return _layout(index, int(d), int(cluster))


def _outputs(x: torch.Tensor, k: int):
    m = x.numel() // x.shape[-1]
    return (torch.empty((m, k), dtype=torch.float32, device=x.device),
            torch.empty((m, k), dtype=torch.int32, device=x.device))


def topk_compress_sharded(x: torch.Tensor, k: int):
    """(values, int32 indices) of the k largest |x| of every row, index-
    ascending, through the cluster kernel ``csrc/topk_sharded.cu`` on a CUDA
    tensor (any d; one launch, no scratch), the plain version on a CPU
    one."""
    d = _check(x, k)
    if x.device.type == "cpu":
        return topk_compress_plain(x, k)
    vals, idx = _outputs(x, k)
    m = vals.shape[0]
    plan = _cluster_plan(m, d)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("topk_sharded", x.data_ptr(), vals.data_ptr(),
                      idx.data_ptr(), m, d, k, plan.cluster, stream)
    return vals.reshape(*x.shape[:-1], k), idx.reshape(*x.shape[:-1], k)


def topk_compress(x: torch.Tensor, k: int):
    """(values, int32 indices) of the k largest |x| of every row, index-
    ascending: on a CUDA tensor the kernel :func:`kernel_plan` picks for d,
    on a CPU tensor the plain version."""
    d = _check(x, k)
    if x.device.type == "cpu":
        return topk_compress_plain(x, k)
    if kernel_plan(d) == "sharded":
        return topk_compress_sharded(x, k)
    vals, idx = _outputs(x, k)
    m = vals.shape[0]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("topk_compress", x.data_ptr(), vals.data_ptr(),
                      idx.data_ptr(), m, d, k, stream)
    return vals.reshape(*x.shape[:-1], k), idx.reshape(*x.shape[:-1], k)


def topk_decompress(vals: torch.Tensor, idx: torch.Tensor, d: int):
    """Receiver-side reconstruction: scatter each row's payload into a dense
    ``(..., d)`` vector with zeros elsewhere."""
    out = torch.zeros((*vals.shape[:-1], d), dtype=vals.dtype,
                      device=vals.device)
    return out.scatter_(-1, idx.long(), vals)
