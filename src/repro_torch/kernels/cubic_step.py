"""Algorithm 2, the cubic sub-problem solve, for a stack of m workers.

Each worker w solves ``min_s g_wᵀs + (γ/2) sᵀH_w s + (Mγ²/6)‖s‖³`` by
gradient descent:

    G = g + γ·H s + (Mγ²/2)·‖s‖·s ;   while ‖G‖ > tol and it < max_iters:
                                          s ← s − lr_w·G ;  recompute G

:func:`cubic_solve` runs the whole loop for all workers. On a CUDA tensor it
launches ``csrc/cubic_solve.cu`` once (one CTA per worker, each stopping on
its own condition), or raises; on a CPU tensor it runs
:func:`cubic_solve_plain`.  :func:`cubic_step` (one iteration, the
reference's ``kernels/cubic_step.py::cubic_step``) and
:func:`cubic_solve_fused` (a fixed number of iterations from s = 0, the
reference's ``cubic_solve_fused``) are the same kernel with ``tol = -1``.
"""
from __future__ import annotations

import torch

from . import _build

MAX_D = 8192  # 3·d floats of dynamic shared memory per CTA (96 KB)


def cubic_solve_plain(g, H, s0, lr, *, M, gamma, tol, max_iters):
    """Plain PyTorch version of :func:`cubic_solve` (same loop, batched:
    finished workers keep their iterate while the others go on)."""
    c = 0.5 * M * gamma**2
    s = s0.clone()
    lr = lr.unsqueeze(-1)
    iters = torch.zeros(g.shape[0], dtype=torch.int32, device=g.device)

    def grad_at(s):
        sn = torch.linalg.vector_norm(s, dim=-1, keepdim=True)
        Hs = torch.matmul(H, s.unsqueeze(-1)).squeeze(-1)
        return g + gamma * Hs + c * sn * s

    G = grad_at(s)
    for _ in range(max_iters):
        active = torch.linalg.vector_norm(G, dim=-1) > tol
        if not bool(active.any()):
            break
        s = torch.where(active.unsqueeze(-1), s - lr * G, s)
        iters += active.to(torch.int32)
        G = grad_at(s)
    return s, iters


def _check(g, H, s0, lr):
    m, d = g.shape
    for name, t, shape in (("g", g, (m, d)), ("H", H, (m, d, d)),
                           ("s0", s0, (m, d)), ("lr", lr, (m,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"cubic_solve: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.dtype != torch.float32:
            raise TypeError(f"cubic_solve: {name} must be float32, "
                            f"got {t.dtype}")
        if t.device != g.device:
            raise ValueError(f"cubic_solve: {name} is on {t.device}, "
                             f"g on {g.device}")


def cubic_solve(g, H, s0=None, lr=None, *, M=10.0, gamma=1.0, tol=1e-6,
                max_iters=500):
    """Solve all m cubic sub-problems: g (m, d), H (m, d, d), s0 (m, d)
    (zeros when None), lr (m,) (the reference's ``1/(γ(‖H‖_F + Mγ) + 1e-8)``
    when None).  Returns ``(s (m, d), iterations (m,) int32)``."""
    if g.dim() != 2:
        raise ValueError(f"cubic_solve takes g of shape (m, d), got "
                         f"{tuple(g.shape)}")
    if s0 is None:
        s0 = torch.zeros_like(g)
    if lr is None:
        lr = default_lr(H, M, gamma)
    _check(g, H, s0, lr)
    if g.device.type == "cpu":
        return cubic_solve_plain(g, H, s0, lr, M=M, gamma=gamma, tol=tol,
                                 max_iters=max_iters)
    if g.device.type != "cuda":
        raise ValueError(f"cubic_solve runs on cuda or cpu, got {g.device}")
    m, d = g.shape
    if d > MAX_D:
        raise ValueError(f"cubic_solve kernel serves d <= {MAX_D}, got {d}")
    g, H, s0, lr = (t.contiguous() for t in (g, H, s0, lr))
    s = torch.empty_like(g)
    iters = torch.empty((m,), dtype=torch.int32, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("cubic_solve", g.data_ptr(), H.data_ptr(),
                      s0.data_ptr(), lr.data_ptr(), s.data_ptr(),
                      iters.data_ptr(), m, d, 0.5 * M * gamma**2, gamma,
                      tol, max_iters, stream)
    return s, iters


def default_lr(H, M, gamma):
    """Algorithm 2's step per worker: ``1/(γ(‖H‖_F + Mγ) + 1e-8)``."""
    fro = torch.linalg.matrix_norm(H, ord="fro")
    return 1.0 / (gamma * (fro + M * gamma) + 1e-8)


def cubic_step(s, g, H, lr, *, M=10.0, gamma=1.0):
    """One Algorithm-2 iteration ``s − lr·G`` for s, g (m, d) or (d,), H
    (m, d, d) or (d, d) and a float step."""
    single = s.dim() == 1
    s2, g2, H2 = (s[None], g[None], H[None]) if single else (s, g, H)
    lr2 = torch.full((s2.shape[0],), float(lr), dtype=torch.float32,
                     device=s.device)
    out, _ = cubic_solve(g2, H2, s2, lr2, M=M, gamma=gamma, tol=-1.0,
                         max_iters=1)
    return out[0] if single else out


def cubic_solve_fused(g, H, *, M=10.0, gamma=1.0, lr=None, n_iters=200):
    """``n_iters`` Algorithm-2 iterations from s = 0 with no tolerance stop,
    for g (d,) and H (d, d) -- the reference's ``cubic_solve_fused``."""
    lr_t = (default_lr(H[None], M, gamma) if lr is None
            else torch.full((1,), float(lr), dtype=torch.float32,
                            device=g.device))
    out, _ = cubic_solve(g[None], H[None], None, lr_t, M=M, gamma=gamma,
                         tol=-1.0, max_iters=n_iters)
    return out[0]
