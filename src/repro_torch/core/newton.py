"""Algorithm 1 — Byzantine-Robust Distributed Cubic-Regularized Newton, the
port of the reference's ``core/newton.py`` (the paper-faithful runtime).

m workers are simulated in one process on one device, their data stacked
on a leading worker axis.  Each round:

1. every worker forms its local gradient and explicit Hessian
   (``torch.func.grad``/``hessian``, batched over the worker axis with
   ``vmap``);
2. every worker solves the cubic sub-problem with Algorithm 2
   (:func:`repro_torch.core.cubic.solve_cubic_gd`, one kernel launch for
   all workers on the card);
3. the updates go up through the uplink :class:`VectorChannel`
   (δ-compression of all m rows in one call, EF/EF21 memory, the Byzantine
   hook, exact :class:`WireLedger` bits);
4. the center aggregates with the resolved rule (``norm_trim`` by default)
   — on the sparse center straight from the top-k payloads;
5. the center broadcasts the step through the downlink channel.

Left for later slices (ROADMAP.md Queue 1b): telemetry round records
(item B4) and the adaptive-k schedule (item B3).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.func import grad, hessian, vmap

from .._device import resolve_device
from ..comm import VectorChannel, WireLedger
from .cubic import solve_cubic_gd


@dataclasses.dataclass(frozen=True)
class NewtonConfig:
    """Hyper-parameters of Algorithm 1 (paper's notation)."""

    M: float = 10.0          # cubic regularization weight
    gamma: float = 1.0       # sub-problem second/third-order emphasis (Remark 1)
    eta: float = 1.0         # step size η_k (paper uses 1 in experiments)
    beta: float = 0.0        # trim fraction (β > α required for resilience)
    solver_tol: float = 1e-6
    solver_iters: int = 500  # cap for Algorithm 2's while-loop
    exact_gradient: bool = False  # Remark 5: extra round ⇒ ε_g = 0
    momentum: float = 0.0    # beyond-paper: CR-with-momentum [WZLL20]
    # compressor spec strings (None ⇒ full precision) for the three wire
    # segments, each its own channel
    compressor: Optional[str] = None           # uplink: worker updates s_i
    downlink_compressor: Optional[str] = None  # center→worker broadcast
    grad_compressor: Optional[str] = None      # Remark-5 gradient round
    error_feedback: str = "ef21"  # "none" | "ef" | "ef21" (tracking)
    ef_damping: float = 0.75      # θ
    # center aggregation rule as a spec string; None keeps the β-field
    # behaviour (norm_trim(β) when β > 0, plain mean otherwise)
    aggregator: Optional[str] = None
    # sparse-domain center: aggregate top-k payloads directly.  None ⇒
    # auto (on whenever the uplink supports the sparse receive and the
    # aggregator has a sparse path); True demands it; False forces dense
    sparse_center: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class AttackConfig:
    name: str = "none"            # a repro_torch.api.attacks rule name
    alpha: float = 0.0            # Byzantine fraction
    sigma: float = 10.0           # gaussian attack scale
    c: float = 0.9                # negative-update attack scale
    scale: float = 5.0            # saddle attack scale
    num_classes: int = 2


class DistributedCubicNewton:
    """Simulated cluster running Algorithm 1 on ``device`` (default the
    card; raises when none is present unless ``device="cpu"``).

    ``loss_fn(w, X, y) -> scalar`` is the per-worker empirical loss;
    workers' data is stacked on a leading axis: ``X: (m, n, d)``,
    ``y: (m, n)``.  One ``step`` = one communication round (two if
    ``exact_gradient``).  Channels are resolved once, at the first step,
    for the observed ``(d, m)``; ``self.ledger`` accumulates exact integer
    uplink/downlink bits host-side.
    """

    runtime_label = "paper"

    def __init__(
        self,
        loss_fn: Callable,
        config: NewtonConfig = NewtonConfig(),
        attack: AttackConfig = AttackConfig(),
        device=None,
    ):
        # the api import is lazy to keep the package import graph acyclic
        from ..api.aggregators import default_aggregator_spec, make_aggregator
        from ..api.attacks import resolve_attack

        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.config = config
        self.attack = attack
        self.aggregator = make_aggregator(
            config.aggregator
            if config.aggregator is not None
            else default_aggregator_spec(config.beta)
        )
        self._attack_rule = resolve_attack(attack)
        self._worker_grads = vmap(grad(loss_fn), in_dims=(None, 0, 0))
        self._worker_hessians = vmap(hessian(loss_fn), in_dims=(None, 0, 0))
        self.rounds_per_step = 2 if config.exact_gradient else 1
        self.ledger = WireLedger()
        self._dims: Optional[tuple] = None
        self._use_sparse_center = False
        self.uplink: Optional[VectorChannel] = None
        self.downlink: Optional[VectorChannel] = None
        self.grad_uplink: Optional[VectorChannel] = None

    # -- channel construction (once per (d, m)) ---------------------------
    def _ensure_channels(self, d: int, m: int):
        if self._dims == (d, m):
            return
        cfg = self.config
        self.uplink = VectorChannel(
            "uplink", cfg.compressor, d, m,
            error_feedback=cfg.error_feedback, damping=cfg.ef_damping,
            attack_hook=self._attack_rule.update_hook(m),
        )
        self.downlink = VectorChannel(
            "downlink", cfg.downlink_compressor, d, 1,
            error_feedback=cfg.error_feedback, damping=cfg.ef_damping,
        )
        # Remark-5 gradient round: its own channel + EF21 state
        self.grad_uplink = VectorChannel(
            "uplink", cfg.grad_compressor, d, m,
            error_feedback=cfg.error_feedback, damping=cfg.ef_damping,
        ) if cfg.exact_gradient else None
        can_sparse = (self.uplink.supports_sparse_receive
                      and self.aggregator.supports_sparse)
        if cfg.sparse_center and not can_sparse:
            raise ValueError(
                "sparse_center=True needs a sparse uplink compressor "
                "(top-k family) with error_feedback='none', no update "
                "attack, and a mean/norm_trim aggregator — got "
                f"compressor={cfg.compressor!r}, "
                f"error_feedback={cfg.error_feedback!r}, "
                f"attack={self.attack.name!r}, "
                f"aggregator={self.aggregator.spec!r}"
            )
        self._use_sparse_center = (can_sparse if cfg.sparse_center is None
                                   else bool(cfg.sparse_center))
        self._dims = (d, m)

    def init_comm_state(self):
        """Fresh channel state (per-worker EF memories) on the device."""
        dev = self.device
        return {
            "uplink": self.uplink.init_state(dev),
            "downlink": self.downlink.init_state(dev),
            "grad": (self.grad_uplink.init_state(dev)
                     if self.grad_uplink is not None
                     else torch.zeros((0,), device=dev)),
        }

    def _check_device(self, **tensors):
        """Raise unless every given tensor lives on ``self.device``: data
        left on the CPU would make the kernel wrappers take their plain
        versions without a word."""
        for name, t in tensors.items():
            if t is not None and t.device != self.device:
                raise ValueError(
                    f"{name} lives on {t.device}, but the algorithm runs on "
                    f"{self.device}; move the data there (or build the "
                    f"algorithm with device={str(t.device)!r})"
                )

    # ------------------------------------------------------------------
    def _worker_solve(self, w, X, y, global_g):
        """All workers: local g (or the global one), local H; solve the
        cubic sub-problems (Eq. 2) in one batched call."""
        cfg = self.config
        if global_g is None:
            g = self._worker_grads(w, X, y)
        else:
            g = global_g.expand(X.shape[0], -1).contiguous()
        H = self._worker_hessians(w, X, y)
        return solve_cubic_gd(g, H, M=cfg.M, gamma=cfg.gamma,
                              tol=cfg.solver_tol, max_iters=cfg.solver_iters)

    def step(self, w, X, y, generator=None, v=None, state=None):
        """One round.  Returns ``(w, v, state, info)`` where ``state`` is the
        channel state (see :meth:`init_comm_state`) and ``info`` holds the
        per-worker ``update_norms``, the aggregator's ``keep`` mask and the
        uplink's measured ``uplink_delta``.  ``generator`` (a
        ``torch.Generator`` on the device) feeds the random attacks."""
        cfg = self.config
        self._check_device(w=w, X=X, y=y, v=v, **{
            f"state[{key!r}]": t for key, t in (state or {}).items()})
        self._ensure_channels(w.shape[0], X.shape[0])
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        v = torch.zeros_like(w) if v is None else v
        state = self.init_comm_state() if state is None else state
        new_state = dict(state)

        # data-level attacks corrupt Byzantine workers' labels before the
        # local computation (they "train on wrong labels", §6)
        y_used = self._attack_rule.corrupt_labels(generator, y)

        global_g = None
        if cfg.exact_gradient:
            # Remark 5: round 1 ships local gradients through the gradient
            # channel; the center aggregates with the same rule
            per_g = self._worker_grads(w, X, y_used)
            per_g, new_state["grad"] = self.grad_uplink.transmit(
                per_g, state["grad"], generator=generator)
            global_g, _ = self.aggregator(per_g)

        s = self._worker_solve(w, X, y_used, global_g)

        if self._use_sparse_center:
            # the (m, k) payloads go straight to the aggregator's sparse
            # path; the m dense vectors never exist at the center
            (pv, pidx), new_state["uplink"], uplink_delta = \
                self.uplink.transmit_sparse(
                    s, state["uplink"], generator=generator, measure=True)
            agg, keep = self.aggregator.sparse(pv, pidx, w.shape[0])
            update_norms = torch.linalg.vector_norm(pv, dim=-1)
        else:
            s, new_state["uplink"], uplink_delta = self.uplink.transmit(
                s, state["uplink"], generator=generator,
                attack_generator=generator, measure=True)
            agg, keep = self.aggregator(s)
            update_norms = torch.linalg.vector_norm(s, dim=-1)
        # optional momentum on the aggregated direction (CRm, [WZLL20])
        v_new = cfg.momentum * v + agg

        # downlink: every worker and the center apply the same
        # reconstruction of the broadcast step, so the cluster stays in sync
        delta, new_state["downlink"] = self.downlink.transmit(
            cfg.eta * v_new, state["downlink"], generator=generator)
        w_new = w + delta
        info = {"update_norms": update_norms, "keep": keep,
                "uplink_delta": uplink_delta}
        return w_new, v_new, new_state, info

    # -- wire accounting ------------------------------------------------
    def bits_per_step(self) -> dict:
        """Exact bits ONE step costs per direction (static Python ints;
        channels must exist).  Two-round mode adds the gradient channel
        uplink and the full-precision gradient broadcast."""
        up = self.uplink.bits_per_round()
        down = self.downlink.bits_per_round()
        if self.grad_uplink is not None:
            up += self.grad_uplink.bits_per_round()
            down += 32 * self.uplink.d  # center broadcasts the averaged g
        return {"uplink": up, "downlink": down}

    def center_bytes_per_round(self) -> int:
        """Bytes the center's aggregation path touches per round: the m
        (value, index) payloads plus the aggregate on the sparse center —
        O(m·k + d) — else m reconstructed f32 vectors plus the aggregate."""
        m, d = self.uplink.n_senders, self.uplink.d
        if self._use_sparse_center:
            k = min(self.uplink.compressor.k, d)
            return m * k * 8 + 4 * d
        return m * d * 4 + 4 * d

    def run(
        self,
        w0,
        X,
        y,
        n_steps: int,
        generator=None,
        eval_fn: Optional[Callable] = None,
        grad_tol: Optional[float] = None,
        saddle_value: Optional[float] = None,
    ):
        """Run Algorithm 1 for ``n_steps`` (or until ‖∇f‖ ≤ grad_tol on the
        pooled data).  Returns ``(w, history)`` with the reference's
        history keys: per-round ``loss``, ``grad_norm``, ``eval``,
        ``bits_cumulative``, ``uplink_delta`` and ``k_trajectory``, the
        ``saddle_escape_step`` and ``truncated`` flags (no deadline is
        ported yet, so ``truncated`` stays False), and the exact ledger
        totals."""
        self._check_device(w0=w0, X=X, y=y)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        Xf, yf = X.reshape(-1, X.shape[-1]), y.reshape(-1)
        gradf = grad(self.loss_fn)

        self._ensure_channels(w0.shape[0], X.shape[0])
        ledger = self.ledger
        ledger.reset()
        hist = {"loss": [], "grad_norm": [], "eval": [], "rounds": 0,
                "bits_cumulative": [], "uplink_delta": [],
                "k_trajectory": [], "saddle_escape_step": None,
                "truncated": False}
        w = w0
        v = torch.zeros_like(w0)
        state = self.init_comm_state()
        for t in range(n_steps):
            w, v, state, info = self.step(w, X, y, generator, v, state)
            bps = self.bits_per_step()
            ledger.record(uplink=bps["uplink"], downlink=bps["downlink"],
                          rounds=self.rounds_per_step)
            hist["bits_cumulative"].append(ledger.total_bits)
            hist["uplink_delta"].append(float(info["uplink_delta"]))
            hist["k_trajectory"].append(None)  # no adaptive wires yet
            gn = float(torch.linalg.vector_norm(gradf(w, Xf, yf)))
            loss = float(self.loss_fn(w, Xf, yf))
            hist["loss"].append(loss)
            hist["grad_norm"].append(gn)
            if eval_fn is not None:
                hist["eval"].append(float(eval_fn(w)))
            if (saddle_value is not None
                    and hist["saddle_escape_step"] is None
                    and loss < saddle_value):
                hist["saddle_escape_step"] = t
            if grad_tol is not None and gn <= grad_tol:
                break
        hist.update(ledger.snapshot())
        return w, hist
