"""The layer-pattern decoder (the port of the reference's
``models/decoder.py``), for the dense decoders built of 'G' and 'L' blocks.

A config resolves to a layer plan ``(unit, reps, tail)`` -- gemma3-27b is
``("LLLLLG", 10, "LL")``.  The reference stacks each unit block's weights on
a leading repeat axis and scans over the repeats, then runs the tail; here
a :class:`Decoder` holds one :class:`~.blocks.Block` per layer, in the order
the scan applies them (global layer ``r·len(unit) + j`` is unit block j of
repeat r, then the tail), and runs them in a Python loop.  Decode keeps one
K/V cache per layer, updated in place.  The encoder (whisper) and the VLM
prefix are not ported.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from .._device import resolve_device
from ..api.errors import not_ported
from . import layers
from .blocks import PORTED, Block, cache_init, init_block

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def layer_plan(cfg) -> Tuple[str, int, str]:
    if cfg.hybrid_pattern:
        unit = cfg.hybrid_pattern
    elif cfg.family == "moe":
        unit = "M"
    elif cfg.family == "ssm":
        unit = "S"
    elif cfg.family == "audio":
        unit = "C"
    elif cfg.local_global_pattern[0] > 0:
        nl, ng = cfg.local_global_pattern
        unit = "L" * nl + "G" * ng
    elif cfg.window > 0:
        unit = "L"
    else:
        unit = "G"
    reps = cfg.num_layers // len(unit)
    tail = unit[: cfg.num_layers % len(unit)]
    return unit, reps, tail


def layer_kinds(cfg) -> List[str]:
    """The block type of every layer, in the order the reference applies
    them; raises for a type the port does not have."""
    unit, reps, tail = layer_plan(cfg)
    kinds = list(unit) * reps + list(tail)
    for kind in set(kinds) - set(PORTED):
        raise not_ported(f"block type {kind!r} ({cfg.name})",
                         "Queue 1 item 14")
    if cfg.family in ("audio", "vlm"):
        raise not_ported(f"the {cfg.family} path ({cfg.name})",
                         "Queue 1 item 14")
    return kinds


def param_dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


class Decoder(nn.Module):
    """The parameters of a dense decoder: token embedding, the layers in
    order, the final norm and the (untied) ``lm_head``."""

    def __init__(self, embed, layers_: List[Block], final_norm, lm_head):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.layers = nn.ModuleList(layers_)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.lm_head = nn.Parameter(lm_head, requires_grad=False)


def init(cfg, seed: int = 0, device=None) -> Decoder:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on the
    device (the card unless ``device="cpu"``): normal(0, 0.02) matrices drawn
    one at a time in float32 and cast to the config's dtype, zero norms."""
    kinds = layer_kinds(cfg)
    dt = param_dtype(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    embed = layers.dense_init(gen, (cfg.padded_vocab, cfg.d_model), dt)
    blocks = [init_block(kind, gen, cfg, dt) for kind in kinds]
    lm_head = layers.dense_init(gen, (cfg.d_model, cfg.padded_vocab), dt)
    final_norm = torch.zeros((cfg.d_model,), dtype=dt, device=dev)
    return Decoder(embed, blocks, final_norm, lm_head)


def forward(params: Decoder, cfg, tokens, *, prefix_emb=None, enc_emb=None):
    """Returns (logits (B, S, padded_vocab), aux loss).  tokens: (B, S)."""
    if prefix_emb is not None or enc_emb is not None:
        raise not_ported("the VLM prefix and the whisper encoder",
                         "Queue 1 item 14")
    x = params.embed[tokens]
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    for block in params.layers:
        x = block.apply(x, cfg, positions)
    x = layers.rms_norm(x, params.final_norm)
    logits = x @ params.lm_head
    # 'G' and 'L' blocks add no auxiliary loss
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def init_cache(cfg, batch: int, max_len: int, device=None) -> list:
    """One K/V cache per layer for one-token decode against a ``max_len``
    context."""
    dt, dev = param_dtype(cfg), resolve_device(device)
    return [cache_init(kind, cfg, batch, max_len, dt, dev)
            for kind in layer_kinds(cfg)]


def decode_step(params: Decoder, cfg, cache: list, tokens, pos: int):
    """One new token.  tokens: (B,) integers; pos: its position (== the
    current cache fill).  Returns (logits (B, V), cache), the cache updated
    in place."""
    x = params.embed[tokens]
    for block, c in zip(params.layers, cache):
        x, _ = block.decode(x, c, cfg, pos)
    x = layers.rms_norm(x, params.final_norm)
    return x @ params.lm_head, cache
