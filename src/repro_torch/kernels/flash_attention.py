"""Attention with an online softmax, causal and sliding-window, on the
model's ``(B, S, H, Dh)`` layout with grouped kv heads -- the contract of
the reference's ``kernels/ref.py::flash_attention_ref``, reached through
``kernels/ops.py::attention_bshd``: ``models/attention.py::
reference_attention`` at ``q_offset = 0``.

* On a CUDA tensor :func:`attention_bshd` launches
  ``csrc/flash_attention.cu``, replacing the reference's Pallas
  ``flash_attention``, or raises: bf16 on the tensor cores (``wgmma`` fed
  by TMA), float32 on the SIMT float32 units, Dh in :data:`HEAD_DIMS`.
  The kernel reads kv head ``h // (H / Hkv)`` in place, where the
  reference repeats the kv heads and transposes to ``(B, H, S, Dh)``
  before its kernel, and takes any S.
* On a CPU tensor it runs :func:`attention_plain`, the plain PyTorch
  version of the same contract.
"""
from __future__ import annotations

import math

import torch

from . import _build

NEG_INF = -1e30
#: the dtypes the kernel takes, by their code in ``csrc/flash_attention.cu``
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the head widths the kernel is built for: those of every configuration
#: the reference ships (whisper 64, the decoders 128, recurrentgemma 256)
HEAD_DIMS = (64, 128, 256)


def attention_plain(q, k, v, *, causal=True, window=0, q_offset=0):
    """Plain PyTorch attention: q (B, Sq, H, Dh), k and v (B, Sk, Hkv, Dh)
    → (B, Sq, H, Dh) in q's dtype.  Float32 logits scaled by 1/√Dh, the
    masked ones set to -1e30, a softmax, the weighted sum of v; query i
    sits at position ``i + q_offset``.  One head at a time, so only one
    (B, Sq, Sk) float32 score tensor is alive."""
    B, Sq, H, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = 1.0 / math.sqrt(Dh)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None and window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    out = torch.empty_like(q)
    for h in range(H):
        kh = k[:, :, h // rep].to(torch.float32)
        logits = torch.matmul(q[:, :, h].to(torch.float32),
                              kh.transpose(1, 2)) * scale
        probs = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
        del logits
        out[:, :, h] = torch.matmul(
            probs, v[:, :, h // rep].to(torch.float32)).to(q.dtype)
    return out


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"attention takes q (B, S, H, Dh) and k, v "
                         f"(B, S, Hkv, Dh), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, Dh = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (B, S, Dh):
        raise ValueError(f"attention: k, v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"attention: {H} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention takes q, k, v of one dtype, float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"attention: q on {q.device}, k on {k.device}, v on "
                         f"{v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention runs on cuda or cpu, got {q.device}")


def attention_bshd(q, k, v, *, causal=True, window=0):
    """q (B, S, H, Dh), k and v (B, S, Hkv, Dh) → (B, S, H, Dh): the kernel
    on CUDA tensors (Dh of :data:`HEAD_DIMS`), :func:`attention_plain` on
    CPU tensors.  ``window`` 0 or None means no sliding window."""
    _check(q, k, v)
    window = int(window or 0)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window)
    B, S, H, Dh = q.shape
    if Dh not in HEAD_DIMS:
        raise ValueError(f"the attention kernel takes Dh in {HEAD_DIMS}, "
                         f"got {Dh} (other head widths: ROADMAP.md Queue 2 "
                         f"item K2)")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("the attention kernel takes 16-byte aligned tensors")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("flash_attention", q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), B, S, H, k.shape[2], Dh,
                      int(bool(causal)), window, DTYPE_CODES[q.dtype], stream)
    return out
