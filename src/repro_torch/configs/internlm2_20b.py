"""internlm2-20b [arXiv:2403.17297].

48L, d_model=6144, 48 heads (GQA kv=8, head_dim=128), d_ff=16384,
vocab=92544.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92544,
    rope_theta=1e6,
    source="InternLM2 [arXiv:2403.17297]",
)
