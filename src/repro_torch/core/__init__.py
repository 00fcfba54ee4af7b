"""The paper's algorithms: Algorithm 1 (:mod:`.newton`), Algorithm 2 and
the exact cubic oracle (:mod:`.cubic`), the center's rules
(:mod:`.aggregation`) and the Byzantine attacks (:mod:`.attacks`)."""
from .cubic import (
    cubic_model_value,
    cubic_residual,
    solve_cubic_exact,
    solve_cubic_gd,
)
from .newton import AttackConfig, DistributedCubicNewton, NewtonConfig

__all__ = [
    "AttackConfig",
    "DistributedCubicNewton",
    "NewtonConfig",
    "cubic_model_value",
    "cubic_residual",
    "solve_cubic_exact",
    "solve_cubic_gd",
]
