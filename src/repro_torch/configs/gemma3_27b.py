"""gemma3-27b [hf:google/gemma-3-1b-pt family].

62L in 5:1 local:global superblocks (local window 1024), d_model=5376,
32 heads (GQA kv=16, head_dim=128), d_ff=21504, vocab=262144, 128k context.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    window=1024,
    local_global_pattern=(5, 1),
    rope_theta=1e6,
    source="Gemma 3 [hf:google/gemma-3-1b-pt]",
)
