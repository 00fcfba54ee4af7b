"""Top-|x| compression of a stack of sender rows: the wire payload of
:class:`repro_torch.compression.TopK`.

:func:`topk_compress` takes ``x`` of shape ``(m, d)`` (or ``(d,)``) and
returns the k largest-magnitude values of every row and their int32
indices, in ascending index order, ties at the threshold magnitude filled
lowest index first -- the contract of the reference's
``kernels/ref.py::topk_compress_ref`` (``lax.top_k``, then the indices
sorted), bit for bit.

* On a CUDA tensor it launches a hand-written kernel, or raises, chosen by
  d as the reference chooses its launch (:func:`kernel_plan`):
  ``csrc/topk_compress.cu`` (one CTA per row) up to
  :data:`SINGLE_TILE_MAX_D`, the bound of the reference's single-tile
  launch, and beyond it :func:`topk_compress_sharded` on
  ``csrc/topk_sharded.cu`` (a grid of row × coordinate-block CTAs, any d).
* On a CPU tensor it runs :func:`topk_compress_plain`, the plain PyTorch
  version of the same contract, at any d.
"""
from __future__ import annotations

import torch

from . import _build

SINGLE_TILE_MAX_D = 1408
#: coordinates per CTA of the sharded kernel (``csrc/topk_sharded.cu``)
SHARDED_BLOCK = 1024
# radix histogram widths of the sharded kernel's three rounds
_HIST_INTS = 1024 + 1024 + 2048


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


def _outputs(x: torch.Tensor, k: int):
    m = x.numel() // x.shape[-1]
    return (torch.empty((m, k), dtype=torch.float32, device=x.device),
            torch.empty((m, k), dtype=torch.int32, device=x.device))


def topk_compress_sharded(x: torch.Tensor, k: int):
    """(values, int32 indices) of the k largest |x| of every row, index-
    ascending, through the sharded kernel ``csrc/topk_sharded.cu`` on a CUDA
    tensor (any d), the plain version on a CPU one.  Its scratch -- three
    radix histograms, the per-row threshold state and the per-block counts
    -- is one int32 buffer allocated here."""
    d = _check(x, k)
    if x.device.type == "cpu":
        return topk_compress_plain(x, k)
    vals, idx = _outputs(x, k)
    m = vals.shape[0]
    scratch = torch.empty((_sharded_scratch_ints(m, d),), dtype=torch.int32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("topk_sharded", x.data_ptr(), vals.data_ptr(),
                      idx.data_ptr(), scratch.data_ptr(), m, d, k, stream)
    return vals.reshape(*x.shape[:-1], k), idx.reshape(*x.shape[:-1], k)


def _sharded_scratch_ints(m: int, d: int) -> int:
    """int32 scratch of the sharded kernel: per row the three histograms,
    the (prefix, count above) state and the per-block sure/tie counts."""
    nb = -(-d // SHARDED_BLOCK)
    return m * (_HIST_INTS + 2 + 2 * nb)


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
