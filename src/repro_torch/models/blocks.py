"""Block registry (the port of the reference's ``models/blocks.py``):
every architecture is a string of block types.

    'G' global causal attention + SwiGLU MLP          (llama/qwen/internlm…)
    'L' sliding-window causal attention + SwiGLU MLP  (gemma3 local)

These two serve the dense decoders.  The reference's other types ('M' MoE,
'S' Mamba-2, 'R' RG-LRU, 'C' cross-attention, 'E' encoder) are not ported
yet and raise, naming their ROADMAP.md item.

A :class:`Block` holds one layer's weights (the reference's per-block dict,
with its names and (in, out) layout) and provides ``apply`` (prefill) and
``decode`` (one token against a KV cache of :func:`cache_init`, updated in
place).  The norms and attention are looked up on their modules at call
time (``layers.rms_norm``, ``attention.chunked_attention``), so the kernel
path and the plain path run the same code.
"""
from __future__ import annotations

import torch
from torch import nn

from ..api.errors import not_ported
from . import attention, layers

PORTED = ("G", "L")


def _frozen(tensors: dict) -> nn.Module:
    """A module whose parameters are ``tensors`` (no gradients: the port
    serves; training is a later slice)."""
    mod = nn.Module()
    for name, t in tensors.items():
        mod.register_parameter(name, nn.Parameter(t, requires_grad=False))
    return mod


class Block(nn.Module):
    """One 'G' or 'L' block: attention + SwiGLU MLP, each behind an RMSNorm
    with a residual add."""

    def __init__(self, kind: str, attn: dict, mlp: dict, norm1, norm2):
        super().__init__()
        if kind not in PORTED:
            raise not_ported(f"block type {kind!r}", "Queue 1 item 14")
        self.kind = kind
        self.attn = _frozen(attn)
        self.mlp = _frozen(mlp)
        self.norm1 = nn.Parameter(norm1, requires_grad=False)
        self.norm2 = nn.Parameter(norm2, requires_grad=False)

    def window(self, cfg) -> int:
        return block_window(self.kind, cfg)

    def _mlp(self, x):
        h2 = layers.rms_norm(x, self.norm2)
        m = self.mlp
        return x + layers.swiglu(h2, m.w_gate, m.w_up, m.w_down)

    def apply(self, x, cfg, positions):
        """x (B, S, d), positions (B, S) → (B, S, d)."""
        B, S, _ = x.shape
        H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        a = self.attn
        h = layers.rms_norm(x, self.norm1)
        q = (h @ a.wq).reshape(B, S, H, Dh)
        k = (h @ a.wk).reshape(B, S, Hkv, Dh)
        v = (h @ a.wv).reshape(B, S, Hkv, Dh)
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
        o = attention.chunked_attention(q, k, v, causal=True,
                                        window=self.window(cfg) or None,
                                        q_chunk=cfg.q_chunk,
                                        kv_chunk=cfg.kv_chunk)
        x = x + o.reshape(B, S, H * Dh) @ a.wo
        return self._mlp(x)

    def decode(self, x, cache, cfg, pos: int):
        """One new token at position ``pos``: x (B, d) → (B, d); its K and V
        are written into ``cache`` in place (slot ``pos``, or ``pos`` modulo
        the rolling window), as the reference's functional update does."""
        B = x.shape[0]
        H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        a = self.attn
        h = layers.rms_norm(x, self.norm1)
        q = (h @ a.wq).reshape(B, 1, H, Dh)
        k = (h @ a.wk).reshape(B, 1, Hkv, Dh)
        v = (h @ a.wv).reshape(B, Hkv, Dh)
        posv = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
        q = layers.apply_rope(q, posv, cfg.rope_theta)[:, 0]
        k = layers.apply_rope(k, posv, cfg.rope_theta)[:, 0]
        S_cache = cache["k"].shape[1]
        if self.window(cfg):
            # rolling window: the slot cycles; every resident entry is in
            # the window
            slot, cache_len = pos % S_cache, min(pos + 1, S_cache)
        else:
            slot, cache_len = pos, pos + 1
        cache["k"][:, slot] = k
        cache["v"][:, slot] = v
        o = attention.decode_attention(q, cache["k"], cache["v"], cache_len)
        x = x + o.reshape(B, H * Dh) @ a.wo
        return self._mlp(x), cache


def block_window(kind: str, cfg) -> int:
    """The sliding window of a block of ``kind`` (0: global attention)."""
    return cfg.window if kind == "L" and cfg.window > 0 else 0


def cache_init(kind: str, cfg, batch, max_len, dtype, device) -> dict:
    """Zero K/V caches of one block; a sliding-window block keeps a rolling
    window of min(window, max_len) slots."""
    w = block_window(kind, cfg)
    S = min(w, max_len) if w else max_len
    shape = (batch, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_block(kind: str, generator, cfg, dtype) -> Block:
    """A block of ``kind`` with normal(0, 0.02) projections drawn from
    ``generator`` (attention, then MLP) and zero norms."""
    zeros = torch.zeros((cfg.d_model,), dtype=dtype, device=generator.device)
    return Block(
        kind,
        layers.init_attention(generator, cfg.d_model, cfg.num_heads,
                              cfg.num_kv_heads, cfg.resolved_head_dim, dtype),
        layers.init_mlp(generator, cfg.d_model, cfg.d_ff, dtype),
        zeros, zeros.clone())
