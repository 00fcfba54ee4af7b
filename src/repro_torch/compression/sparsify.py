"""Sparsifying compressors: transmit k (value, index) pairs of every sender
row and reconstruct dense-with-zeros (the port of the reference's
``compression/sparsify.py``).

* Top-k keeps the k largest magnitudes: deterministic, δ = k/d.
* Random-k keeps a uniform k-subset: δ = k/d in expectation over the draw,
  which is why it pairs with error feedback.  The index set derives from a
  shared seed, so only the k values and the 32-bit seed ship.
"""
from __future__ import annotations

import torch

from ..kernels import topk_compress, topk_compress_plain, topk_decompress
from .base import SCALE_BITS, Compressor, index_bits


_SEED_BITS = 32


class _SparseCompressor(Compressor):
    """Shared wire format: k (value, index) pairs → dense-with-zeros."""

    def decompress(self, payload, d):
        vals, idx = payload
        return topk_decompress(vals, idx, d)

    def delta_bound(self, d):
        return min(self.k, d) / d


class TopK(_SparseCompressor):
    """Keep the k largest-magnitude coordinates (ties → lowest index).

    ``use_kernel=True`` compresses through
    :func:`repro_torch.kernels.topk_compress`: the hand-written top-k kernel
    on the card, one launch for all sender rows.  The default path is plain
    PyTorch (:func:`repro_torch.kernels.topk_compress_plain`).  Both give the
    same payload and the same :meth:`wire_bits`.
    """

    def __init__(self, k: int, value_bits: int = 32, use_kernel: bool = False):
        if k < 1:
            raise ValueError(f"top-k needs k ≥ 1, got {k}")
        self.k = int(k)
        self.value_bits = value_bits
        self.use_kernel = use_kernel
        self.name = f"topk({self.k})"

    def compress(self, x, *, generator=None):
        k = min(self.k, x.shape[-1])
        if self.use_kernel:
            return topk_compress(x, k)
        return topk_compress_plain(x, k)

    def wire_bits(self, d):
        k = min(self.k, d)
        return k * (self.value_bits + index_bits(d))


class RandomK(_SparseCompressor):
    """Transmit k uniformly chosen coordinates of every sender row, the index
    sets drawn from the ``torch.Generator`` the channel passes.

    All rows are drawn in one call on x's device, which must be the
    generator's (torch raises otherwise): the first k of an argsort of
    uniform keys is a uniform k-subset without replacement; each row's
    indices are sorted ascending.  Biased and only δ = k/d in expectation
    -- pair with error feedback for convergence.
    """

    def __init__(self, k: int):
        if k < 1:
            raise ValueError(f"random-k needs k ≥ 1, got {k}")
        self.k = int(k)
        self.name = f"randk({self.k})"

    def compress(self, x, *, generator=None):
        if generator is None:
            raise ValueError("RandomK.compress needs a torch.Generator")
        d = x.shape[-1]
        k = min(self.k, d)
        rows = x.reshape(-1, d)
        keys = torch.rand(rows.shape, generator=generator, device=x.device)
        idx = torch.sort(torch.argsort(keys, dim=-1)[:, :k], dim=-1).values
        vals = torch.gather(rows, 1, idx)
        shape = (*x.shape[:-1], k)
        return vals.reshape(shape), idx.reshape(shape)

    def wire_bits(self, d):
        # float32 values; the index set is re-derivable from a shared
        # 32-bit seed
        return min(self.k, d) * SCALE_BITS + _SEED_BITS
