"""Block-wise int8 quantization -- 8 bits a coordinate + one float32 scale
a block (the port of the reference's ``compression/quant.py``).

Each block of ``block`` coordinates is scaled by its max|x|/127 (1.0 for an
all-zero block), rounded half to even and clipped to [−127, 127].  The
per-coordinate error is at most max|x_b|/254, so per block

    ‖x_b − C(x_b)‖² ≤ block · ‖x_b‖² / 4·127²

and δ ≥ 1 − block/64516.  The tail block is zero-padded; padded zeros
quantize exactly and are not billed on the wire.  Every sender row of an
``(..., d)`` stack is blocked on its own.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .._device import div_exact
from .base import SCALE_BITS, Compressor

_MAX_BLOCK = 4 * 127**2   # beyond it the δ bound above is not positive


class BlockInt8(Compressor):
    def __init__(self, block: int = 128):
        if not 1 <= block <= _MAX_BLOCK:
            raise ValueError(f"block too large for a nontrivial δ: "
                             f"need 1 <= block <= {_MAX_BLOCK}, got {block}")
        self.block = int(block)
        self.name = f"int8({self.block})"

    def _nblocks(self, d):
        return -(-d // self.block)

    def compress(self, x, *, generator=None):
        """x (..., d) → (int8 codes (..., nb, block), float32 scales
        (..., nb))."""
        d = x.shape[-1]
        nb = self._nblocks(d)
        xb = F.pad(x.to(torch.float32), (0, nb * self.block - d))
        xb = xb.reshape(*x.shape[:-1], nb, self.block)
        amax = torch.amax(torch.abs(xb), dim=-1, keepdim=True)
        scale = torch.where(amax > 0, div_exact(amax, 127.0),
                            torch.ones_like(amax))
        q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
        return q, scale[..., 0]

    def decompress(self, payload, d):
        q, scale = payload
        xb = q.to(torch.float32) * scale[..., None]
        return xb.reshape(*q.shape[:-2], -1)[..., :d]

    def wire_bits(self, d):
        return d * 8 + self._nblocks(d) * SCALE_BITS

    def delta_bound(self, d):
        return 1.0 - min(self.block, d) / (4.0 * 127.0**2)
