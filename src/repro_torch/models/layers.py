"""Shared neural-net layers of the model zoo (the port of the reference's
``models/layers.py``).

Weights keep the reference's (in, out) layout and are used as ``x @ W``.
:func:`rms_norm` goes through the RMSNorm kernel on a CUDA tensor
(:func:`repro_torch.kernels.rmsnorm_nd`) and its plain version on a CPU
tensor; the projections and the MLP are matrix products outside any
kernel, as the reference leaves them to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import rmsnorm_nd

INIT_SCALE = 0.02


def dense_init(generator: torch.Generator, shape, dtype, scale=INIT_SCALE):
    """``scale`` × a standard normal draw of ``shape`` on the generator's
    device, drawn in float32 and cast to ``dtype`` at once (one float32
    tensor alive at a time)."""
    w = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def rms_norm(x, weight, eps=1e-6):
    """``x·rsqrt(mean(x²) + eps)·(1 + w)`` over the last axis, in float32,
    cast back to x's dtype."""
    return rmsnorm_nd(x, weight, eps=eps)


def rope_freqs(head_dim, theta=1e4, device=None):
    """The (head_dim/2,) inverse frequencies, float32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta=1e4):
    """x: (..., S, H, Dh); positions: (..., S) integers.  Rotates the two
    halves of the head dim in float32 and casts back."""
    dh = x.shape[-1]
    inv = rope_freqs(dh, theta, device=x.device)
    ang = positions[..., None].to(torch.float32) * inv      # (..., S, Dh/2)
    sin = torch.sin(ang)[..., None, :]                       # over the heads
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU MLP: down( silu(x·gate) ⊙ (x·up) )."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def init_mlp(generator, d_model, d_ff, dtype):
    return {
        "w_gate": dense_init(generator, (d_model, d_ff), dtype),
        "w_up": dense_init(generator, (d_model, d_ff), dtype),
        "w_down": dense_init(generator, (d_ff, d_model), dtype),
    }


def init_attention(generator, d_model, num_heads, num_kv_heads, head_dim,
                   dtype):
    return {
        "wq": dense_init(generator, (d_model, num_heads * head_dim), dtype),
        "wk": dense_init(generator, (d_model, num_kv_heads * head_dim), dtype),
        "wv": dense_init(generator, (d_model, num_kv_heads * head_dim), dtype),
        "wo": dense_init(generator, (num_heads * head_dim, d_model), dtype),
    }
