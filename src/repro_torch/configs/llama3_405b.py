"""llama3-405b [arXiv:2407.21783].

126L, d_model=16384, 128 heads (GQA kv=8, head_dim=128), d_ff=53248,
vocab=128256, RoPE θ=500000.

``VARIANT_SWA`` adds a 4096 sliding window on every layer — the optional
dense-arch sub-quadratic variant that unlocks the ``long_500k`` shape.
"""
import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=5e5,
    source="Llama 3 [arXiv:2407.21783]",
)

VARIANT_SWA = dataclasses.replace(
    CONFIG, name="llama3-405b-swa", window=4096, local_global_pattern=(1, 0)
)
