"""Top-k sparsification: transmit the k largest-magnitude (value, index)
pairs of every sender row and reconstruct dense-with-zeros (the port of the
reference's ``compression/sparsify.py``; random-k is a later slice).

Top-k is a deterministic δ-approximate compressor with δ = k/d.
"""
from __future__ import annotations

from ..kernels import topk_compress, topk_compress_plain, topk_decompress
from .base import Compressor, index_bits


class _SparseCompressor(Compressor):
    """Shared wire format: k (value, index) pairs → dense-with-zeros."""

    def decompress(self, payload, d):
        vals, idx = payload
        return topk_decompress(vals, idx, d)


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
