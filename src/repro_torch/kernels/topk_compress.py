"""Top-|x| compression of a stack of sender rows: the wire payload of
:class:`repro_torch.compression.TopK`.

:func:`topk_compress` takes ``x`` of shape ``(m, d)`` (or ``(d,)``) and
returns the k largest-magnitude values of every row and their int32
indices, in ascending index order, ties at the threshold magnitude filled
lowest index first -- the contract of the reference's
``kernels/ref.py::topk_compress_ref`` (``lax.top_k``, then the indices
sorted), bit for bit.

* On a CUDA tensor it launches the hand-written kernel
  ``csrc/topk_compress.cu`` (one CTA per row, one launch for the stack), or
  raises.  It serves d up to :data:`SINGLE_TILE_MAX_D`, the bound of the
  reference's single-tile launch; beyond it the reference switches to its
  sharded two-pass kernels, which are not ported yet, so it raises.
* On a CPU tensor it runs :func:`topk_compress_plain`, the plain PyTorch
  version of the same contract.
"""
from __future__ import annotations

import torch

from . import _build

SINGLE_TILE_MAX_D = 1408


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
    if d > SINGLE_TILE_MAX_D:
        raise NotImplementedError(
            f"top-k kernel at d={d} > {SINGLE_TILE_MAX_D}: the reference's "
            f"sharded launch (topk_compress_sharded, _hist_kernel and "
            f"_pack_kernel) is not ported yet -- ROADMAP.md Queue 2 item 4"
        )
    return d


def topk_compress(x: torch.Tensor, k: int):
    """(values, int32 indices) of the k largest |x| of every row, index-
    ascending: the kernel on a CUDA tensor, the plain version on a CPU one."""
    d = _check(x, k)
    if x.device.type == "cpu":
        return topk_compress_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"topk_compress runs on cuda or cpu, got {x.device}")
    x2 = x.reshape(-1, d)
    if not x2.is_contiguous():
        raise ValueError("topk_compress takes a contiguous tensor")
    m = x2.shape[0]
    vals = torch.empty((m, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((m, k), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("topk_compress", x2.data_ptr(), vals.data_ptr(),
                      idx.data_ptr(), m, d, k, stream)
    return vals.reshape(*x.shape[:-1], k), idx.reshape(*x.shape[:-1], k)


def topk_decompress(vals: torch.Tensor, idx: torch.Tensor, d: int):
    """Receiver-side reconstruction: scatter each row's payload into a dense
    ``(..., d)`` vector with zeros elsewhere."""
    out = torch.zeros((*vals.shape[:-1], d), dtype=vals.dtype,
                      device=vals.device)
    return out.scatter_(-1, idx.long(), vals)
