"""Carry the reference's state into the port.

The reference's arrays cannot be replayed from a seed in PyTorch (its
random draws come from JAX's threefry), so the tests hand them over as
numpy: the problem's data, the iterate ``w``, the momentum ``v``, the
channel-state dict ``{"uplink", "downlink", "grad"}`` and a model's
parameter tree.  Anything
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
from .models.blocks import Block
from .models.decoder import Decoder, layer_kinds, layer_plan, param_dtype

_PROBLEM_ARRAYS = ("X_workers", "y_workers", "w0", "X_full", "y_full",
                   "X_test", "y_test", "w_star")


def to_tensor(a, device=None, dtype=torch.float32) -> torch.Tensor:
    """One array → a tensor of ``dtype`` on ``device`` (copied)."""
    arr = np.array(a, copy=True)
    return torch.from_numpy(arr).to(device=resolve_device(device),
                                    dtype=dtype)


def problem_from_reference(ref, device=None) -> Problem:
    """The reference's ``Problem`` (any object with its attributes) → the
    port's, over the same arrays, with its start and saddle value."""
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


def model_params_from_reference(params: Mapping, cfg, device=None) -> Decoder:
    """The reference's model parameter tree (``repro.models`` ``init``: a
    nested dict of arrays, each unit block stacked on a leading repeat
    axis) → the port's :class:`~repro_torch.models.decoder.Decoder`, in the
    config's dtype.  Global layer ``r·len(unit) + j`` is
    ``params["unit"][f"b{j}"]`` at repeat ``r``, the scan's order; the tail
    follows.  Weights keep their (in, out) layout."""
    dev = resolve_device(device)
    dt = param_dtype(cfg)

    def t(a):
        # through float32: numpy has no bfloat16 of its own
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=dev, dtype=dt)

    def block(kind, p, r=None):
        pick = (lambda a: a) if r is None else (lambda a: a[r])
        return Block(kind,
                     {n: t(pick(p["attn"][n])) for n in ("wq", "wk", "wv",
                                                         "wo")},
                     {n: t(pick(p["mlp"][n])) for n in ("w_gate", "w_up",
                                                        "w_down")},
                     t(pick(p["norm1"])), t(pick(p["norm2"])))

    layer_kinds(cfg)  # raises for a block type the port does not have
    unit, reps, tail = layer_plan(cfg)
    blocks = [block(kind, params["unit"][f"b{j}"], r)
              for r in range(reps) for j, kind in enumerate(unit)]
    blocks += [block(kind, params["tail"][f"b{j}"])
               for j, kind in enumerate(tail)]
    return Decoder(t(params["embed"]), blocks, t(params["final_norm"]),
                   t(params["lm_head"]))
