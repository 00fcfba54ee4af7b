"""`repro_torch.api` — the declarative experiment facade (the port of the
reference's ``repro.api`` for the paper runtime): the aggregator, attack
and problem registries and :class:`ExperimentSpec`, whose
``build(device=None)`` returns a ready :class:`Experiment`."""
from .aggregators import (
    AGGREGATOR_SPECS,
    Aggregator,
    default_aggregator_spec,
    make_aggregator,
)
from .attacks import (
    ATTACK_SPECS,
    ResolvedAttack,
    make_attack,
    resolve_attack,
    to_attack_config,
)
from .errors import SpecError
from .experiment import Experiment, ExperimentSpec
from .problems import (
    PROBLEM_SPECS,
    Problem,
    accuracy,
    factor_loss,
    fixed_workers,
    logistic_loss,
    make_problem,
    problem_dim,
    robust_regression_loss,
)

__all__ = [
    "AGGREGATOR_SPECS",
    "ATTACK_SPECS",
    "Aggregator",
    "Experiment",
    "ExperimentSpec",
    "PROBLEM_SPECS",
    "Problem",
    "ResolvedAttack",
    "SpecError",
    "accuracy",
    "default_aggregator_spec",
    "factor_loss",
    "fixed_workers",
    "logistic_loss",
    "make_aggregator",
    "make_attack",
    "make_problem",
    "problem_dim",
    "resolve_attack",
    "robust_regression_loss",
    "to_attack_config",
]
