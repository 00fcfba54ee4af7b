"""codeqwen1.5-7b [hf:Qwen/CodeQwen1.5-7B].

32L, d_model=4096, 32 heads with kv=32 (full MHA — qwen1.5 arch),
d_ff=13440, vocab=92416.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab_size=92416,
    rope_theta=1e6,
    source="CodeQwen1.5 [hf:Qwen/CodeQwen1.5-7B]",
)
