"""Byzantine attack library (the attacks of the paper's §6), the port of
the reference's ``core/attacks.py``.

* **update-level** — corrupt the update ``s_i`` a Byzantine worker sends:
  ``gaussian`` (s_i + N(0, σ²)), ``negative`` (−c·s_i) and ``saddle``
  (colluding workers send a common scaled random unit direction);
* **data-level** — corrupt the worker's labels before it computes its
  gradient/Hessian: ``random_label`` and ``flipped_label``.

Randomness comes from an explicit ``torch.Generator`` on the tensors'
device (the reference's threefry keys cannot be replayed, so the draws
differ from the reference's; tests compare the deterministic attacks).
"""
from __future__ import annotations

from typing import Callable

import torch

from .._device import resolve_device


def byzantine_mask(m: int, alpha: float, device=None) -> torch.Tensor:
    """First ⌊αm⌋ workers are Byzantine (deterministic, as in the paper's
    experiments where the fraction — not the identity — matters)."""
    n_byz = int(alpha * m)
    return torch.arange(m, device=resolve_device(device)) < n_byz


def _rows(mask, like):
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


# -------------------- update-level attacks: (m,d) -> (m,d) -----------------


def gaussian_attack(generator, updates, mask, sigma=10.0):
    noise = sigma * torch.randn(updates.shape, generator=generator,
                                device=updates.device, dtype=updates.dtype)
    return torch.where(_rows(mask, updates), updates + noise, updates)


def negative_update_attack(generator, updates, mask, c=0.9):
    del generator
    return torch.where(_rows(mask, updates), -c * updates, updates)


def saddle_attack(generator, updates, mask, direction=None, scale=5.0):
    """Colluding workers all send ``scale · direction`` — a fake descent
    direction toward a saddle (fake-local-minimum construction of §5)."""
    if direction is None:
        direction = torch.randn(updates.shape[1:], generator=generator,
                                device=updates.device, dtype=updates.dtype)
        direction = direction / (torch.linalg.vector_norm(direction) + 1e-12)
    fake = torch.broadcast_to(scale * direction, updates.shape)
    return torch.where(_rows(mask, updates), fake, updates)


UPDATE_ATTACKS: dict[str, Callable] = {
    "none": lambda generator, u, mask, **kw: u,
    "gaussian": gaussian_attack,
    "negative": negative_update_attack,
    "saddle": saddle_attack,
}


# -------------------- data-level attacks: labels (m, n) -> (m, n) ----------


def random_label_attack(generator, labels, mask, num_classes=2):
    rnd = torch.randint(0, num_classes, labels.shape, generator=generator,
                        device=labels.device).to(labels.dtype)
    return torch.where(_rows(mask, labels), rnd, labels)


def flipped_label_attack(generator, labels, mask, num_classes=2):
    del generator
    flipped = (num_classes - 1) - labels
    return torch.where(_rows(mask, labels), flipped, labels)


LABEL_ATTACKS: dict[str, Callable] = {
    "none": lambda generator, y, mask, **kw: y,
    "random_label": random_label_attack,
    "flipped_label": flipped_label_attack,
}
