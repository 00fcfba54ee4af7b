"""Cubic sub-problem solvers (the inner problem of the paper's Algorithm 1),
the port of the reference's ``core/cubic.py`` for explicit Hessians.

Every worker solves, on its local gradient g and Hessian H (Eq. (2)):

    s* = argmin_s  gᵀs + (γ/2) sᵀHs + (M γ²/6) ‖s‖³

* :func:`solve_cubic_exact` — eigendecomposition + bisection on the
  Nesterov–Polyak secular equation; the test oracle (small d).
* :func:`solve_cubic_gd` — the paper's Algorithm 2 for a stack of workers:
  gradient descent on the sub-problem while ‖G‖ > τ, capped at
  ``max_iters``, each worker stopping on its own condition.  On the card
  the whole loop is one launch of the cubic-solve kernel
  (:func:`repro_torch.kernels.cubic_solve`).

The reference's matrix-free ``solve_cubic_hvp`` belongs to the mesh-runtime
slice.  First-order optimality (Lemma 4, Eq. 16): g + γHs + (Mγ²/2)‖s‖s = 0.
"""
from __future__ import annotations

import torch

from ..kernels import cubic_solve


def solve_cubic_exact(g, H, M=10.0, gamma=1.0, n_bisect=100):
    """Nesterov–Polyak exact solution via eigendecomposition + bisection
    for g (..., d) and H (..., d, d).

    ``s = -(γH + (Mγ²/2) r I)^{-1} g`` with ``r = ‖s‖`` the root of the
    strictly decreasing ``φ(r) = ‖(γH + (Mγ²/2) r I)^{-1} g‖ − r`` on
    ``r > max(0, −2λ_min(H)/(Mγ))``.
    """
    evals, evecs = torch.linalg.eigh(H)
    u = (evecs.transpose(-1, -2) @ g.unsqueeze(-1)).squeeze(-1)
    c = 0.5 * M * gamma**2
    r_lo = torch.clamp(-2.0 * evals[..., 0] / (M * gamma), min=0.0) + 1e-12
    gnorm = torch.linalg.vector_norm(g, dim=-1)
    r_hi = r_lo + torch.sqrt(2.0 * gnorm / (M * gamma**2) + 1e-12) + gnorm / (
        c * (r_lo + 1e-6)
    )

    def secular_norm(r):
        denom = gamma * evals + c * r.unsqueeze(-1)
        return torch.sqrt(torch.sum((u / denom) ** 2, dim=-1))

    lo, hi = r_lo, r_hi
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        up = secular_norm(mid) - mid > 0
        lo = torch.where(up, mid, lo)
        hi = torch.where(up, hi, mid)
    r = 0.5 * (lo + hi)
    denom = gamma * evals + c * r.unsqueeze(-1)
    return -(evecs @ (u / denom).unsqueeze(-1)).squeeze(-1)


def solve_cubic_gd(g, H, M=10.0, gamma=1.0, lr=None, tol=1e-6,
                   max_iters=2000):
    """The paper's Algorithm 2 for g (m, d) and H (m, d, d) (or one worker,
    g (d,) and H (d, d)):

        s ← 0;  G ← g
        while ‖G‖ > τ and it < max_iters:
            s ← s − ξ G
            G ← g + γ H s + (Mγ²/2) ‖s‖ s

    with ξ = ``lr`` or, by default, 1/(γ(‖H‖_F + Mγ) + 1e-8) per worker.
    """
    single = g.dim() == 1
    g2, H2 = (g[None], H[None]) if single else (g, H)
    lr2 = None
    if lr is not None:
        lr2 = torch.as_tensor(lr, dtype=torch.float32, device=g.device)
        lr2 = lr2.expand(g2.shape[0]).contiguous()
    s, _ = cubic_solve(g2, H2, None, lr2, M=M, gamma=gamma, tol=tol,
                       max_iters=max_iters)
    return s[0] if single else s


def cubic_model_value(s, g, H, M=10.0, gamma=1.0):
    """Sub-problem objective value m(s) for one worker."""
    return (
        g @ s
        + 0.5 * gamma * s @ (H @ s)
        + M / 6.0 * gamma**2 * torch.linalg.vector_norm(s) ** 3
    )


def cubic_residual(s, g, H, M=10.0, gamma=1.0):
    """‖g + γHs + (Mγ²/2)‖s‖s‖ — first-order stationarity residual (Eq. 16),
    per worker for stacked inputs."""
    Hs = (H @ s.unsqueeze(-1)).squeeze(-1)
    sn = torch.linalg.vector_norm(s, dim=-1, keepdim=True)
    G = g + gamma * Hs + 0.5 * M * gamma**2 * sn * s
    return torch.linalg.vector_norm(G, dim=-1)
