"""Attack registry: spec strings → resolved :class:`ResolvedAttack` (the
port of the reference's ``api/attacks.py``, flat-vector runtime only):

    "none"                no corruption
    "gaussian:10.0"       s_i + N(0, σ²) on Byzantine updates
    "negative:0.9"        −c · s_i  (norm-preserving sign flip)
    "saddle:5.0"          colluding fake descent direction toward a
                          saddle (scale · random unit vector)
    "random_label"        Byzantine workers train on random labels
    "flipped_label"       … on flipped labels ("flip" is an alias)

The resolved object owns the Byzantine mask, the channel injection hook
``update_hook(m)`` — ``(generator, (m, d) stacked) → corrupted`` — and the
label-corruption entry point ``corrupt_labels(generator, y)``.
"""
from __future__ import annotations

from typing import Callable, Optional

from ..core import attacks as attacks_lib
from .errors import SpecError

# head → (scale-parameter name, default scale)
_UPDATE = {
    "gaussian": ("sigma", 10.0),
    "negative": ("c", 0.9),
    "saddle": ("scale", 5.0),
}
_LABEL = ("random_label", "flipped_label")
_ALIASES = {"flip": "flipped_label", "label_flip": "flipped_label"}

ATTACK_SPECS = ("none", "gaussian:<sigma>", "negative:<c>", "saddle:<scale>",
                "random_label", "flipped_label")


class ResolvedAttack:
    """One attack scenario: rule + strength + Byzantine fraction."""

    def __init__(self, name: str, alpha: float, *,
                 param: Optional[float] = None, num_classes: int = 2):
        self.name = name
        self.alpha = float(alpha)
        self.num_classes = int(num_classes)
        if name == "none" or self.alpha <= 0:
            self.kind = "none"
            self.kwargs: dict = {}
            self.spec = "none"
            return
        if name in _UPDATE:
            self.kind = "update"
            pname, default = _UPDATE[name]
            value = default if param is None else float(param)
            self.kwargs = {pname: value}
            self.spec = f"{name}:{value!r}"
        elif name in _LABEL:
            self.kind = "label"
            self.kwargs = {"num_classes": self.num_classes}
            self.spec = name
        else:
            raise SpecError(
                f"unknown attack {name!r}; expected one of {ATTACK_SPECS}"
            )

    def mask(self, m: int, device=None):
        return attacks_lib.byzantine_mask(m, self.alpha, device)

    def update_hook(self, m: int) -> Optional[Callable]:
        """Channel injection hook over (m, d) stacked vectors."""
        if self.kind != "update":
            return None
        fn = attacks_lib.UPDATE_ATTACKS[self.name]
        kw = self.kwargs

        def hook(generator, s):
            return fn(generator, s, self.mask(m, s.device), **kw)

        return hook

    def corrupt_labels(self, generator, y):
        """Data-level corruption of the (m, n) label block (no-op unless
        this is a label attack)."""
        if self.kind != "label":
            return y
        return attacks_lib.LABEL_ATTACKS[self.name](
            generator, y, self.mask(y.shape[0], y.device),
            num_classes=self.num_classes,
        )

    def __repr__(self):
        return f"ResolvedAttack({self.spec!r}, alpha={self.alpha!r})"


def make_attack(spec, alpha: float = 0.0, *,
                num_classes: int = 2) -> ResolvedAttack:
    """Resolve an attack spec string at the given Byzantine fraction α."""
    if isinstance(spec, ResolvedAttack):
        return spec
    if spec is None:
        spec = "none"
    if not isinstance(spec, str):
        raise SpecError(f"attack spec must be a string, got {spec!r}")
    head, _, arg = spec.partition(":")
    head = _ALIASES.get(head, head)
    if head != "none" and head not in _UPDATE and head not in _LABEL:
        raise SpecError(
            f"unknown attack spec {spec!r}; expected one of {ATTACK_SPECS}"
        )
    if arg and head not in _UPDATE:
        raise SpecError(f"attack {head!r} takes no parameter, got {spec!r}")
    param = None
    if arg:
        try:
            param = float(arg)
        except ValueError:
            raise SpecError(
                f"attack spec {spec!r}: parameter must be a number"
            ) from None
    return ResolvedAttack(head, alpha, param=param, num_classes=num_classes)


def resolve_attack(cfg) -> ResolvedAttack:
    """An :class:`~repro_torch.core.newton.AttackConfig` (name + per-attack
    fields) → the resolved form the runtime consumes."""
    param = {"gaussian": cfg.sigma, "negative": cfg.c,
             "saddle": cfg.scale}.get(cfg.name)
    return ResolvedAttack(cfg.name, cfg.alpha, param=param,
                          num_classes=cfg.num_classes)


def to_attack_config(spec, alpha: float = 0.0, *, num_classes: int = 2):
    """Spec string → :class:`~repro_torch.core.newton.AttackConfig`."""
    make_attack(spec, alpha, num_classes=num_classes)  # validate grammar
    from ..core.newton import AttackConfig  # runtime import: no cycle

    head, _, arg = (spec or "none").partition(":")
    head = _ALIASES.get(head, head)
    kw = {}
    if arg and head in _UPDATE:
        kw[_UPDATE[head][0]] = float(arg)
    return AttackConfig(name=head, alpha=alpha, num_classes=num_classes, **kw)
