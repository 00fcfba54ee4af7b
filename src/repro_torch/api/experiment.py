"""`ExperimentSpec` — the declarative description every entry point builds
through; the port of the reference's ``api/experiment.py`` for the paper
runtime.

The fields are the reference's, so a reference spec's ``to_dict()`` loads
here unchanged (``ExperimentSpec.from_dict``).  ``validate()`` runs the
build-time checks of the paper runtime (β > α resilience, the spec
grammar of the three registries, error feedback without a compressor) and
raises :class:`~repro_torch.api.errors.SpecError`; a spec that needs a
part of the reference this slice does not port yet (another runtime or
solver, a mesh problem, an async axis) raises
:class:`NotImplementedError` naming its ROADMAP.md item.
``build(device=None)`` validates and returns a ready :class:`Experiment`
on the card (or on the CPU when ``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import torch

from .._device import resolve_device
from ..compression.registry import make_compressor
from .aggregators import make_aggregator
from .attacks import make_attack, to_attack_config
from .errors import SpecError, not_ported
from .problems import Problem, fixed_workers, make_problem, problem_dim

_PAPER_SOLVER_ITERS = 500   # Algorithm 2 while-loop cap (paper runtime)

#: async-runtime axes and their degenerate-synchronous defaults; omitted
#: from ``to_dict`` at these values, as the reference omits them
_ASYNC_AXIS_DEFAULTS = {
    "participation": 1.0,
    "staleness": 0,
    "drop": 0.0,
    "duplicate": 0.0,
    "staleness_decay": 0.5,
}
_SOLVER_DEFAULT = "cubic_newton"


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """Declarative experiment description (all fields JSON scalars)."""

    # -- problem / runtime selector --------------------------------------
    problem: str = "synthetic-logistic:4000:40"
    runtime: str = "paper"          # only "paper" is ported
    m_workers: int = 20
    # -- solver (Algorithm 1 / 2) ----------------------------------------
    M: float = 10.0
    gamma: float = 1.0
    eta: float = 1.0
    solver_tol: float = 1e-6
    solver_iters: Optional[int] = None   # None → 500
    exact_gradient: bool = False         # Remark 5: two-round, ε_g = 0
    momentum: float = 0.0
    # -- the three wire segments (compression spec strings) --------------
    compressor: Optional[str] = None           # uplink: worker updates
    downlink_compressor: Optional[str] = None  # center→worker broadcast
    grad_compressor: Optional[str] = None      # Remark-5 gradient round
    error_feedback: Optional[str] = None       # None → auto (see below)
    ef_damping: float = 0.75
    # -- solver axis (only "cubic_newton" is ported) ----------------------
    solver: str = "cubic_newton"
    # -- resilience scenario ---------------------------------------------
    aggregator: str = "mean"        # repro_torch.api.aggregators spec
    attack: str = "none"            # repro_torch.api.attacks spec
    alpha: float = 0.0              # Byzantine fraction
    num_classes: int = 2
    seed: int = 0
    # -- async-runtime axes (not ported; must keep their defaults) --------
    participation: float = 1.0
    staleness: int = 0
    drop: float = 0.0
    duplicate: float = 0.0
    staleness_decay: float = 0.5

    # ------------------------------------------------------------ serde
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for key, default in _ASYNC_AXIS_DEFAULTS.items():
            if d[key] == default:
                del d[key]
        if d["solver"] == _SOLVER_DEFAULT:
            del d["solver"]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise SpecError(
                f"unknown ExperimentSpec fields {sorted(unknown)}; "
                f"known fields: {sorted(known)}"
            )
        return cls(**d)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(s))

    def replace(self, **kw) -> "ExperimentSpec":
        return dataclasses.replace(self, **kw)

    # --------------------------------------------------------- resolution
    @property
    def any_compressor(self) -> bool:
        return any((self.compressor, self.downlink_compressor,
                    self.grad_compressor))

    def resolved_error_feedback(self) -> str:
        """``None`` means auto: EF21 when any channel is compressed."""
        if self.error_feedback is not None:
            return self.error_feedback
        return "ef21" if self.any_compressor else "none"

    # --------------------------------------------------------- validation
    def validate(self) -> "ExperimentSpec":
        if self.runtime not in ("paper", "mesh", "async"):
            raise SpecError(
                f"runtime must be 'paper', 'mesh', or 'async', "
                f"got {self.runtime!r}"
            )
        if self.runtime == "async":
            raise not_ported("runtime='async'", "Queue 1 item 11")
        if self.runtime == "mesh":
            raise not_ported("runtime='mesh'", "Queue 1 item 13")
        for field, default in _ASYNC_AXIS_DEFAULTS.items():
            if getattr(self, field) != default:
                raise SpecError(
                    f"{field}={getattr(self, field)!r} is an async-runtime "
                    f"axis, but runtime={self.runtime!r} — drop the override"
                )
        if self.solver != _SOLVER_DEFAULT:
            raise not_ported(f"solver={self.solver!r}", "Queue 1 item 10")
        if self.m_workers < 2:
            raise SpecError(
                f"m_workers={self.m_workers}: need ≥ 2 workers for "
                f"aggregation to mean anything"
            )
        if not 0.0 <= self.alpha < 0.5:
            raise SpecError(
                f"alpha={self.alpha!r}: the Byzantine fraction must lie in "
                f"[0, 0.5) — no aggregator survives a corrupted majority"
            )
        for field in ("M", "gamma", "eta"):
            if getattr(self, field) <= 0:
                raise SpecError(f"{field} must be positive, "
                                f"got {getattr(self, field)!r}")
        if not 0.0 <= self.momentum < 1.0:
            raise SpecError(f"momentum must be in [0, 1), "
                            f"got {self.momentum!r}")

        dim = problem_dim(self.problem)
        fixed_m = fixed_workers(self.problem)
        if fixed_m is not None and self.m_workers != fixed_m:
            raise SpecError(
                f"problem {self.problem!r} partitions over a fixed "
                f"m={fixed_m} machines, but the spec says "
                f"m_workers={self.m_workers} — set m_workers={fixed_m}, or "
                f"use a synthetic problem to vary the cluster size"
            )

        # aggregator + attack grammar and the resilience precondition
        agg = make_aggregator(self.aggregator)
        make_attack(self.attack, self.alpha, num_classes=self.num_classes)
        if self.alpha > 0 and agg.name != "mean":
            # "mean" under attack is the deliberate non-robust baseline
            reason = agg.check_resilience(self.alpha, self.m_workers)
            if reason is not None:
                raise SpecError(
                    f"aggregator {agg.spec!r} cannot resist the configured "
                    f"attack: {reason}"
                )

        # channel specs
        if self.grad_compressor is not None and not self.exact_gradient:
            raise SpecError(
                "grad_compressor compresses the Remark-5 gradient round, "
                "which only exists with exact_gradient=True — enable it or "
                "drop grad_compressor"
            )
        for field in ("compressor", "downlink_compressor", "grad_compressor"):
            spec = getattr(self, field)
            if spec is None:
                continue
            try:
                make_compressor(spec, dim)
            except ValueError as e:
                raise SpecError(f"{field}={spec!r}: {e}") from None

        ef = self.resolved_error_feedback()
        if ef not in ("none", "ef", "ef21"):
            raise SpecError(
                f"error_feedback={self.error_feedback!r}: expected "
                f"'none', 'ef', or 'ef21'"
            )
        if ef != "none" and self.error_feedback is not None \
                and not self.any_compressor:
            raise SpecError(
                f"error_feedback={self.error_feedback!r} tracks a "
                f"compressor's residual, but all three channel compressors "
                f"are None — set compressor=... (e.g. 'topk:0.1') or drop "
                f"the error_feedback override"
            )
        return self

    # --------------------------------------------------------- config gen
    def to_newton_config(self):
        """Validated spec → :class:`repro_torch.core.NewtonConfig`."""
        self.validate()
        from ..core.newton import NewtonConfig  # runtime import: no cycle

        agg = make_aggregator(self.aggregator)
        return NewtonConfig(
            M=self.M, gamma=self.gamma, eta=self.eta,
            beta=getattr(agg, "beta", 0.0),
            solver_tol=self.solver_tol,
            solver_iters=self.solver_iters or _PAPER_SOLVER_ITERS,
            exact_gradient=self.exact_gradient, momentum=self.momentum,
            compressor=self.compressor,
            downlink_compressor=self.downlink_compressor,
            grad_compressor=self.grad_compressor,
            error_feedback=self.resolved_error_feedback(),
            ef_damping=self.ef_damping,
            aggregator=self.aggregator,
        )

    def to_attack_config(self):
        """Validated spec → :class:`repro_torch.core.AttackConfig`."""
        return to_attack_config(self.attack, self.alpha,
                                num_classes=self.num_classes)

    # ------------------------------------------------------------- build
    def build(self, device=None, problem: Optional[Problem] = None
              ) -> "Experiment":
        """Validate, materialize the problem on ``device`` (default the
        card; raises when none is present unless ``device="cpu"``), and
        wire up the runtime.  ``problem`` replaces the materialized data —
        e.g. the reference's arrays through :mod:`repro_torch.interop`."""
        dev = resolve_device(device)
        self.validate()
        return Experiment(self, dev, problem)


class Experiment:
    """A built, ready-to-run experiment.

    ``run(n_steps, grad_tol=...)`` returns ``(iterate, history)``; the
    history carries ``loss``, the adaptive uplink's ``k_trajectory`` and
    the exact-int wire-ledger totals.
    ``.problem`` holds the data and ``.algo`` the
    :class:`~repro_torch.core.DistributedCubicNewton`.
    """

    def __init__(self, spec: ExperimentSpec, device,
                 problem: Optional[Problem] = None):
        from ..core.newton import DistributedCubicNewton

        self.spec = spec
        self.device = device
        if problem is None:
            problem = make_problem(spec.problem, spec.m_workers, spec.seed,
                                   device)
        elif problem.device != device:
            raise ValueError(f"problem lives on {problem.device}, the "
                             f"experiment on {device}")
        self.problem = problem
        self.config = spec.to_newton_config()
        self.algo = DistributedCubicNewton(
            problem.loss_fn, self.config, spec.to_attack_config(),
            device=device,
        )

    def run(self, n_steps: int = 10, *, grad_tol: Optional[float] = None,
            eval_fn=None, seed: Optional[int] = None):
        """Run the experiment; returns ``(iterate, history)``.  Random
        attacks draw from a generator seeded with ``seed`` (default the
        spec's)."""
        gen = torch.Generator(device=self.device).manual_seed(
            self.spec.seed if seed is None else int(seed))
        p = self.problem
        return self.algo.run(
            p.w0, p.X_workers, p.y_workers, n_steps, generator=gen,
            eval_fn=eval_fn if eval_fn is not None else p.eval_fn,
            grad_tol=grad_tol, saddle_value=p.saddle_value,
        )
