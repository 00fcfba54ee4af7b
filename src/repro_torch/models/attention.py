"""Attention of the model zoo (the port of the reference's
``models/attention.py``): the prefill path and the KV-cache decode path.

* :func:`chunked_attention` -- the training/prefill path, memory-bounded
  attention with an online softmax.  The reference computes it in pure JAX
  over query and key chunks; its Pallas kernel implements the same
  contract, and here that kernel's port serves it:
  :func:`repro_torch.kernels.attention_bshd`, ``csrc/flash_attention.cu`` on
  a CUDA tensor, the plain version on a CPU tensor.  The reference's chunk
  sizes are TPU tiling knobs and not semantics: the kernel picks its own
  tiles, and any S works without padding.
* :func:`reference_attention` -- the O(S²)-memory oracle, plain PyTorch.
* :func:`decode_attention` -- one query token against a cache, plain
  PyTorch (the reference has no kernel for it).
"""
from __future__ import annotations

import math

import torch

from ..kernels import attention_bshd, attention_plain

NEG_INF = -1e30


def _repeat_kv(k, num_heads):
    """GQA: repeat kv heads to match query heads. k: (B, S, Hkv, Dh)."""
    hkv = k.shape[2]
    if hkv == num_heads:
        return k
    return torch.repeat_interleave(k, num_heads // hkv, dim=2)


def reference_attention(q, k, v, *, causal=True, window=None, q_offset=0):
    """O(S²)-memory oracle.  q: (B, Sq, H, Dh), k/v: (B, Sk, Hkv, Dh)."""
    return attention_plain(q, k, v, causal=causal, window=window or 0,
                           q_offset=q_offset)


def chunked_attention(q, k, v, *, causal=True, window=None, q_chunk=512,
                      kv_chunk=512):
    """Memory-bounded attention with the contract of
    :func:`reference_attention` at ``q_offset = 0`` and Sq == Sk.
    ``q_chunk``/``kv_chunk`` are accepted for the reference's signature and
    not used."""
    del q_chunk, kv_chunk
    return attention_bshd(q, k, v, causal=causal, window=window or 0)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=None):
    """One-token decode against a cache.

    q: (B, H, Dh); caches: (B, S_max, Hkv, Dh); cache_len: int -- the number
    of valid positions (the new token's KV already written at
    ``cache_len - 1``).  Returns (B, H, Dh).
    """
    B, S_max, Hkv, Dh = k_cache.shape
    H = q.shape[1]
    k = _repeat_kv(k_cache, H).to(torch.float32)
    v = _repeat_kv(v_cache, H).to(torch.float32)
    scale = 1.0 / math.sqrt(Dh)
    logits = torch.einsum("bhd,bkhd->bhk", q.to(torch.float32), k) * scale
    kpos = torch.arange(S_max, device=q.device)
    mask = kpos < cache_len
    if window is not None and window > 0:
        mask &= kpos >= cache_len - window
    logits = torch.where(mask[None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", probs, v)
    return out.to(q.dtype)
