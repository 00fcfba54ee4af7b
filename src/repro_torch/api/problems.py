"""Problem catalog: spec strings → ready-to-run distributed problems.

The port of the reference's ``api/problems.py`` for the paper runtime:

    "a9a-logistic" / "w8a-logistic"      paper §6 logistic regression
    "a9a-robust"   / "w8a-robust"        paper §6 robust regression
    "synthetic-logistic:<n>:<d>"         separable classification twin
    "synthetic-regression:<n>:<d>"       heavy-tailed robust regression

``matrix-factor`` and the mesh-only ``quadratic`` problem belong to later
slices and raise :class:`NotImplementedError`.  The data are twins drawn
from a seeded ``torch.Generator`` on the problem's device;
:meth:`Problem.from_numpy` takes arrays made elsewhere (the reference's,
in the tests).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..configs import PAPER_WORKLOADS
from ..data import (
    make_classification,
    make_regression,
    paper_dataset,
    shard_to_workers,
)
from .errors import SpecError, not_ported

PROBLEM_SPECS = tuple(PAPER_WORKLOADS) + (
    "synthetic-logistic:<n>:<d>", "synthetic-regression:<n>:<d>",
)
_LATER = {"matrix-factor": "Queue 1b item B5",
          "quadratic": "Queue 1 item 13 (mesh runtime)"}


# ---------------------------------------------------------------- losses
def logistic_loss(w, X, y):
    """Eq. (8): regularized logistic regression (λ/2n scaling as in paper).
    Written as the reference writes it: ``log1p(exp(·))``, not
    ``softplus``, whose linearisation above 20 changes the numbers."""
    z = X @ w
    yy = 2.0 * y - 1.0
    return (torch.mean(torch.log1p(torch.exp(-yy * z)))
            + 0.5 / X.shape[0] * (w @ w))


def robust_regression_loss(w, X, y):
    """Eq. (9): non-convex robust linear regression."""
    r = y - X @ w
    return torch.mean(torch.log(r * r / 2.0 + 1.0))


# ------------------------------------------------- closed-form Hessians
# Both catalog losses are GLMs, f(w) = mean_j φ(x_jᵀw) (+ a ridge term), so
# each worker's Hessian is Xᵀ·diag(φ''(z))·X / n: one batched product over
# the m workers, with no (m, d, n, d) intermediate of vmap(hessian(...)).


def _glm_hessians(X, curvature):
    """Xᵀ·diag(curvature)·X / n for X (m, n, d) and curvature (m, n); the
    division is in place, so the (m, d, d) result is the only large
    allocation."""
    H = torch.bmm(X.transpose(1, 2) * curvature[:, None, :], X)
    return H.div_(X.shape[1])


def logistic_hessians(X, y, w):
    """Per-worker Hessians of :func:`logistic_loss` (Eq. 8) at w (d,), for
    X (m, n, d), y (m, n): Xᵀ·diag(σ(z)σ(−z))·X/n + I/n with z = Xw.  The
    labels drop out (ỹ² = 1); the ridge term 0.5/n·‖w‖² gives the I/n."""
    z = X @ w
    H = _glm_hessians(X, torch.sigmoid(z) * torch.sigmoid(-z))
    H.diagonal(dim1=1, dim2=2).add_(1.0 / X.shape[1])
    return H


def robust_regression_hessians(X, y, w):
    """Per-worker Hessians of :func:`robust_regression_loss` (Eq. 9) at w
    (d,), for X (m, n, d), y (m, n): Xᵀ·diag((1 − r²/2)/(1 + r²/2)²)·X/n
    with r = y − Xw."""
    a = 0.5 * (y - X @ w) ** 2
    return _glm_hessians(X, (1.0 - a) / (1.0 + a) ** 2)


#: closed-form batched Hessians of the catalog losses, keyed by the loss
HESSIANS = {logistic_loss: logistic_hessians,
            robust_regression_loss: robust_regression_hessians}


def accuracy(w, X, y):
    return float(((X @ w > 0) == (y > 0.5)).to(torch.float32).mean())


_LOSSES = {"logistic": logistic_loss, "robust_regression": robust_regression_loss}


# ---------------------------------------------------------------- catalog
@dataclasses.dataclass
class Problem:
    """Materialized problem: loss + worker-sharded data + metadata."""

    spec: str
    kind: str                 # "logistic" | "robust_regression"
    loss_fn: Callable
    dim: int
    m_workers: int
    X_workers: torch.Tensor = None
    y_workers: torch.Tensor = None
    w0: torch.Tensor = None
    X_full: torch.Tensor = None
    y_full: torch.Tensor = None
    X_test: Optional[torch.Tensor] = None
    y_test: Optional[torch.Tensor] = None
    w_star: Optional[torch.Tensor] = None
    saddle_value: Optional[float] = None

    @property
    def device(self) -> torch.device:
        return self.X_workers.device

    @property
    def eval_fn(self) -> Optional[Callable]:
        """Test accuracy for classification problems, else None."""
        if self.kind == "logistic" and self.X_test is not None:
            return lambda w: accuracy(w, self.X_test, self.y_test)
        return None

    @classmethod
    def from_numpy(cls, spec: str, kind: str, *, X_workers, y_workers,
                   w0=None, X_full=None, y_full=None, X_test=None,
                   y_test=None, w_star=None, saddle_value=None,
                   device=None) -> "Problem":
        """A problem over arrays made elsewhere (anything ``np.asarray``
        takes), copied to float32 tensors on ``device`` (default the card;
        raises when none is present unless ``device="cpu"``)."""
        if kind not in _LOSSES:
            raise SpecError(f"problem kind {kind!r} is not one of "
                            f"{sorted(_LOSSES)}")
        dev = resolve_device(device)

        def t(a):
            if a is None:
                return None
            return torch.from_numpy(
                np.array(a, dtype=np.float32, copy=True)).to(dev)

        Xw = t(X_workers)
        m, _, d = Xw.shape
        return cls(
            spec=spec, kind=kind, loss_fn=_LOSSES[kind], dim=d, m_workers=m,
            X_workers=Xw, y_workers=t(y_workers),
            w0=t(w0) if w0 is not None else torch.zeros(d, device=dev),
            X_full=t(X_full), y_full=t(y_full), X_test=t(X_test),
            y_test=t(y_test), w_star=t(w_star), saddle_value=saddle_value,
        )


def _ints(spec: str, arg: str, defaults: tuple) -> tuple:
    parts = [p for p in arg.split(":") if p]
    try:
        vals = tuple(int(p) for p in parts)
    except ValueError:
        raise SpecError(
            f"problem spec {spec!r}: size parameters must be integers"
        ) from None
    if len(vals) > len(defaults):
        raise SpecError(
            f"problem spec {spec!r}: at most {len(defaults)} parameters"
        )
    return vals + defaults[len(vals):]


def fixed_workers(spec: str) -> Optional[int]:
    """Cluster size a problem pins (the paper workloads partition over a
    fixed 20 machines); None when m_workers is free."""
    if spec in PAPER_WORKLOADS:
        return PAPER_WORKLOADS[spec].m_workers
    return None


def problem_dim(spec: str) -> int:
    """The flat iterate dimension a spec implies."""
    if spec in PAPER_WORKLOADS:
        return PAPER_WORKLOADS[spec].dim
    head, _, arg = spec.partition(":")
    if head in ("synthetic-logistic", "synthetic-regression"):
        return _ints(spec, arg, (4000, 40))[1]
    if head in _LATER:
        raise not_ported(f"problem {spec!r}", _LATER[head])
    raise SpecError(
        f"unknown problem spec {spec!r}; expected one of {PROBLEM_SPECS}"
    )


def make_problem(spec: str, m_workers: int, seed: int = 0,
                 device=None) -> Problem:
    """Materialize a problem's data on ``device`` (default the card; raises
    when none is present unless ``device="cpu"``) from the seed."""
    dev = resolve_device(device)
    if spec in PAPER_WORKLOADS:
        wl = PAPER_WORKLOADS[spec]
        data = paper_dataset(wl, seed, dev)
        return Problem(
            spec=spec, kind=wl.problem, loss_fn=_LOSSES[wl.problem],
            dim=wl.dim, m_workers=wl.m_workers,
            X_workers=data["X_workers"], y_workers=data["y_workers"],
            w0=torch.zeros(wl.dim, device=dev),
            X_full=data["X_train"], y_full=data["y_train"],
            X_test=data["X_test"], y_test=data["y_test"],
        )

    head, _, arg = spec.partition(":")
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    if head in ("synthetic-logistic", "synthetic-regression"):
        n, d = _ints(spec, arg, (4000, 40))
        if head == "synthetic-logistic":
            kind = "logistic"
            X, y, w_star = make_classification(gen, n, d, margin=3.0)
        else:
            kind = "robust_regression"
            X, y, w_star = make_regression(gen, n, d)
        Xw, yw = shard_to_workers(X, y, m_workers)
        return Problem(spec=spec, kind=kind, loss_fn=_LOSSES[kind], dim=d,
                       m_workers=m_workers, X_workers=Xw, y_workers=yw,
                       w0=torch.zeros(d, device=dev), X_full=X, y_full=y,
                       w_star=w_star)
    problem_dim(spec)  # raises: a later slice's problem, or unknown
    raise SpecError(f"unknown problem spec {spec!r}")
