"""Carry the reference's state into the port.

The reference's arrays cannot be replayed from a seed in PyTorch (its
random draws come from JAX's threefry), so the tests hand them over as
numpy: the problem's data, the iterate ``w``, the momentum ``v`` and the
channel-state dict ``{"uplink", "downlink", "grad"}``.  Anything
``np.asarray`` accepts works, so this module imports neither ``jax`` nor
``repro``.  Like every entry point of the port, each function puts its
tensors on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ._device import resolve_device
from .api.problems import Problem

_PROBLEM_ARRAYS = ("X_workers", "y_workers", "w0", "X_full", "y_full",
                   "X_test", "y_test", "w_star")


def to_tensor(a, device=None, dtype=torch.float32) -> torch.Tensor:
    """One array → a tensor of ``dtype`` on ``device`` (copied)."""
    arr = np.array(a, copy=True)
    return torch.from_numpy(arr).to(device=resolve_device(device),
                                    dtype=dtype)


def problem_from_reference(ref, device=None) -> Problem:
    """The reference's ``Problem`` (any object with its attributes) → the
    port's, over the same arrays."""
    arrays = {name: getattr(ref, name, None) for name in _PROBLEM_ARRAYS}
    return Problem.from_numpy(ref.spec, ref.kind, device=device,
                              saddle_value=getattr(ref, "saddle_value", None),
                              **arrays)


def state_from_reference(state: Mapping, device=None) -> dict:
    """The reference's channel state ``{"uplink", "downlink", "grad"}``
    (per-sender EF memories) → the port's."""
    return {key: to_tensor(state[key], device)
            for key in ("uplink", "downlink", "grad")}


def iterate_from_reference(w, v=None, device=None):
    """The reference's iterate ``w`` (and momentum ``v``, zeros when None)
    → tensors on ``device``."""
    w_t = to_tensor(w, device)
    v_t = torch.zeros_like(w_t) if v is None else to_tensor(v, device)
    return w_t, v_t
