"""RMSNorm over the last axis, Gemma-style: ``x·rsqrt(mean(x²) + eps)·(1 + w)``
in float32, the result in x's type -- the contract of the reference's
``kernels/ref.py::rmsnorm_ref``, which is ``models/layers.py::rms_norm``.

* On a CUDA tensor :func:`rmsnorm` launches ``csrc/rmsnorm.cu`` (one CTA
  per row), replacing the reference's Pallas ``rmsnorm``, or raises.
* On a CPU tensor it runs :func:`rmsnorm_plain`, the plain PyTorch
  version of the same contract.

Any number of rows: the reference's Pallas kernel asserts
``N % block_rows == 0``, and the decode path has N = batch.
"""
from __future__ import annotations

import torch

from . import _build

#: the dtypes the kernel takes, by their code in ``csrc/rmsnorm.cu``
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """Plain PyTorch RMSNorm over the last axis (the reference's formula,
    term for term)."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + w.to(torch.float32))
    return out.to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm takes x (N, d) and w (d,), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    for t in (x, w):
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"rmsnorm takes float32 or bfloat16, got "
                            f"{t.dtype}")
    if w.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, w on {w.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rmsnorm runs on cuda or cpu, got {x.device}")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6):
    """x (N, d), w (d,) → (N, d) in x's dtype: the kernel on a CUDA tensor,
    :func:`rmsnorm_plain` on a CPU tensor."""
    _check(x, w)
    if x.device.type == "cpu":
        return rmsnorm_plain(x, w, eps)
    n, d = x.shape
    x = x.contiguous()
    w = w.contiguous()
    out = torch.empty_like(x)
    # 16-byte loads when every row starts on a 16-byte boundary
    vector = int(x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
                 and (d * x.element_size()) % 16 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("rmsnorm", x.data_ptr(), w.data_ptr(), out.data_ptr(),
                      n, d, float(eps), DTYPE_CODES[x.dtype],
                      DTYPE_CODES[w.dtype], vector, stream)
    return out


def rmsnorm_nd(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6):
    """RMSNorm over the last axis of a tensor of any batch shape (the
    reference's ``ops.py::rmsnorm_nd``)."""
    shape = x.shape
    return rmsnorm(x.reshape(-1, shape[-1]), w, eps=eps).reshape(shape)
