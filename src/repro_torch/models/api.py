"""Public model API (the port of the reference's ``models/api.py``):
``build_model(cfg, device=None)`` → a :class:`Model` facade that binds the
config and the device and exposes the reference's functions.

``loss_fn`` (training) is a later slice and raises; the reference's
sharding hooks (``models/runtime.py``) belong to the mesh slice.
"""
from __future__ import annotations

import dataclasses

import torch

from .._device import resolve_device
from ..api.errors import not_ported
from ..configs.base import ModelConfig
from . import decoder


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device

    def init(self, seed: int = 0) -> decoder.Decoder:
        return decoder.init(self.cfg, seed, self.device)

    def forward(self, params, tokens, **mods):
        """(logits, aux) of ``tokens`` (B, S)."""
        return decoder.forward(params, self.cfg, tokens, **mods)

    def loss_fn(self, params, batch):
        raise not_ported("the training path (loss_fn)",
                         "Queue 1 items 14-15")

    def init_cache(self, batch: int, max_len: int) -> list:
        return decoder.init_cache(self.cfg, batch, max_len, self.device)

    def decode_step(self, params, cache, tokens, pos: int):
        """(logits (B, V), cache) after one token at position ``pos``."""
        return decoder.decode_step(params, self.cfg, cache, tokens, pos)

    @staticmethod
    def param_count(params) -> int:
        return sum(p.numel() for p in params.parameters())


def build_model(cfg: ModelConfig, device=None) -> Model:
    """The model of ``cfg`` on ``device`` (the card unless ``"cpu"``)."""
    decoder.layer_kinds(cfg)  # raises for what the port does not have
    return Model(cfg=cfg, device=resolve_device(device))
