"""Algorithm 2, the cubic sub-problem solve, for a stack of m workers.

Each worker w solves ``min_s g_wᵀs + (γ/2) sᵀH_w s + (Mγ²/6)‖s‖³`` by
gradient descent:

    G = g + γ·H s + (Mγ²/2)·‖s‖·s ;   while ‖G‖ > tol and it < max_iters:
                                          s ← s − lr_w·G ;  recompute G

:func:`cubic_solve` runs the whole loop for all workers. On a CUDA tensor it
launches ``csrc/cubic_solve.cu`` once, or raises; on a CPU tensor it runs
:func:`cubic_solve_plain`.  The kernel gives each worker a thread block
cluster of C CTAs, each owning d/C rows of H, and serves any d whose H the
card holds.  :func:`cubic_plan` says how a launch is laid out
(:class:`CubicPlan`):

* ``"resident"`` -- each CTA's rows of H fit its shared memory and stay
  there for the whole solve (d up to about 940; C the smallest cluster that
  holds them and leaves each CTA at most 64 rows: w8a's d = 300 takes
  C = 5).  An iteration is then bound by latency: the warps' passes, the
  stores to the other CTAs and one cluster barrier.
* ``"streamed"`` -- H streams from device memory every iteration, and the
  bytes bound it: Σ_w iters_w · d² · 4 B at 3.35 TB/s (about 142 ms at
  gisette's d = 5000, m = 20).  C is the largest cluster size for which all
  m clusters are resident at once, so the CTAs cover the card.
* ``"streamed_global_s"`` -- past d = 28544 the iterate's two buffers leave
  shared memory for an (m, 2, d) scratch in device memory.

:func:`cubic_step` (one iteration, the reference's
``kernels/cubic_step.py::cubic_step``) and :func:`cubic_solve_fused` (a fixed
number of iterations from s = 0, the reference's ``cubic_solve_fused``) are
the same kernel with ``tol = -1``.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import _build

#: the kernel's launch modes, by the code its C entry points use
MODES = ("resident", "streamed", "streamed_global_s")


@dataclass(frozen=True)
class CubicPlan:
    """How :func:`cubic_solve` lays out a launch on the card: ``cluster``
    CTAs a worker, the ``mode`` (one of :data:`MODES`), the shared memory of
    a CTA and how many such clusters the card holds at once."""
    cluster: int
    mode: str
    smem_bytes: int
    max_active_clusters: int


@functools.lru_cache(maxsize=256)
def _plan(device_index: int, m: int, d: int):
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device_index):
        _build.query("cubic_solve_plan", m, d, out)
    return CubicPlan(out[0], MODES[out[1]], out[2], out[3])


def cubic_plan(m: int, d: int, *, device=None) -> CubicPlan:
    """The launch plan the kernel's rules (``csrc/cubic_solve.cu``) pick for
    m workers at width d on a card (the current one when ``device`` is
    None); cached per device and shape."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"cubic_plan lays out a launch on a card, got {dev}")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return _plan(index, int(m), int(d))


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
    if m == 0 or d == 0:
        return s0.clone(), torch.zeros((m,), dtype=torch.int32,
                                       device=g.device)
    g, H, s0, lr = (t.contiguous() for t in (g, H, s0, lr))
    s = torch.empty_like(g)
    iters = torch.empty((m,), dtype=torch.int32, device=g.device)
    plan = cubic_plan(m, d, device=g.device)
    scratch = (torch.empty((m, 2, d), dtype=torch.float32, device=g.device)
               if plan.mode == "streamed_global_s" else None)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch("cubic_solve", g.data_ptr(), H.data_ptr(),
                      s0.data_ptr(), lr.data_ptr(), s.data_ptr(),
                      iters.data_ptr(),
                      None if scratch is None else scratch.data_ptr(), m, d,
                      0.5 * M * gamma**2, gamma, tol, max_iters,
                      plan.cluster, MODES.index(plan.mode), stream)
    return s, iters


def default_lr(H, M, gamma):
    """Algorithm 2's step per worker: ``1/(γ(‖H‖_F + Mγ) + 1e-8)``.

    ‖H‖_F is the norm of the row norms: PyTorch's float32
    ``matrix_norm(ord="fro")`` on the CPU sums all d² squares in one pass
    and is off by 1e-3 (relative) at d = 4352, where the norm of row norms
    agrees with float64 to 1e-7, as the reference's ``jnp.linalg.norm``
    does."""
    fro = torch.linalg.vector_norm(torch.linalg.vector_norm(H, dim=-1),
                                   dim=-1)
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
