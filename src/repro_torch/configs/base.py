"""ModelConfig — the single config record every architecture instantiates.

A copy of the reference's ``configs/base.py`` (the port imports nothing of
``repro``).  One ``<arch>.py`` per architecture fills it in with the
published numbers (source cited in each file).  ``reduced()`` gives the
CPU smoke-test variant (a few layers, d_model ≤ 256, ≤4 experts).
``q_chunk`` and ``kv_chunk`` are the reference's TPU tile sizes; the port's
attention kernel picks its own tiles and ignores them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads

    # attention pattern ------------------------------------------------
    window: int = 0                     # >0 ⇒ sliding-window on local layers
    local_global_pattern: Tuple[int, int] = (0, 1)  # (n_local, n_global) per group
    rope_theta: float = 1e4

    # MoE ----------------------------------------------------------------
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    router_z_weight: float = 1e-3

    # SSM (mamba2 / SSD) -------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    conv_width: int = 4

    # hybrid (recurrentgemma): block pattern over layer types -------------
    # 'R' = RG-LRU recurrent block, 'A' = local-attention block
    hybrid_pattern: str = ""

    # enc-dec (whisper) ----------------------------------------------------
    encoder_layers: int = 0
    encoder_len: int = 1500   # stub frame-embedding length

    # vlm -----------------------------------------------------------------
    num_prefix_tokens: int = 0  # stub patch/frame embeddings prepended

    # numerics / memory -----------------------------------------------------
    dtype: str = "bfloat16"
    remat: bool = True
    q_chunk: int = 512
    kv_chunk: int = 512
    logits_dtype: str = "float32"

    # citation for the config numbers
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the embedding/lm_head can
        shard evenly over the 16-way model axis (MaxText-style padding).
        Targets always stay < vocab_size; padded logits are harmless."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic? (the reference's skip policy for long_500k)."""
        if self.family in ("ssm", "hybrid"):
            return True
        # dense archs qualify only with a sliding-window component
        return self.window > 0 and self.local_global_pattern[0] > 0

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs are decoders (whisper = enc-dec)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family/wiring, tiny sizes."""
        hd = min(self.resolved_head_dim, 64)
        nh = min(self.num_heads, 4)
        nkv = max(1, min(self.num_kv_heads, nh))
        nkv = nh // max(1, nh // nkv)  # keep divisibility
        pat = self.hybrid_pattern[:3] if self.hybrid_pattern else ""
        if pat:
            n_layers = len(pat)
        elif self.local_global_pattern[0] > 0:
            # keep one full local:global unit so the smoke test exercises both
            n_layers = sum(self.local_global_pattern)
        else:
            n_layers = 2
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=n_layers,
            d_model=min(self.d_model, 256),
            num_heads=nh,
            num_kv_heads=nkv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            num_shared_experts=min(self.num_shared_experts, 1),
            top_k=min(self.top_k, 2) if self.top_k else 0,
            # generous capacity so smoke decode == smoke forward (no drops)
            capacity_factor=4.0,
            expert_d_ff=min(self.expert_d_ff, 128) if self.expert_d_ff else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=min(self.ssm_head_dim, 16),
            ssm_chunk=16,
            window=min(self.window, 16) if self.window else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_len=16 if self.encoder_layers else self.encoder_len,
            num_prefix_tokens=min(self.num_prefix_tokens, 8),
            hybrid_pattern=pat,
            q_chunk=16,
            kv_chunk=16,
            dtype="float32",
            remat=False,
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
