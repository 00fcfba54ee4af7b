"""The matrix-factor saddle-escape testbed in the port against the
reference: ``factor_loss`` and its derivatives, the strict saddle, an
attack-free run over the reference's arrays, the escape grid of the robust
rules under attack (the port's own attack draws, at seed 0), the ``mean``
contrast, the port's own twin, and the quickstart spec."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, hessian

from repro.api import ExperimentSpec as JaxSpec
from repro.api import factor_loss as jax_factor_loss
from repro.api import make_problem as jax_make_problem
from repro.core.cubic import solve_cubic_gd as jax_solve_cubic_gd
from repro_torch import interop
from repro_torch.api import (
    ExperimentSpec,
    Problem,
    SpecError,
    factor_loss,
    make_problem,
)
from repro_torch.kernels import cubic_solve_plain, default_lr

torch.set_num_threads(1)

SPEC = "matrix-factor:10:2"
M_WORKERS = 10
# the robust rules of the reference's escape test, through their kernel
# heads (the card runs the same specs)
RULES = ("norm_trim:0.3", "krum_kernel:2", "trimmed_mean_kernel:0.2",
         "coordinate_median_kernel")
ESCAPE = 0.2          # final loss below ESCAPE · saddle_value


def _ref_problem():
    return jax_make_problem(SPEC, M_WORKERS, 0)


def _port_problem(jp=None):
    return interop.problem_from_reference(jp or _ref_problem(), device="cpu")


def test_factor_loss_and_derivatives_match_reference():
    """Loss, gradient (``torch.func.grad`` against ``jax.grad``) and Hessian
    (``torch.func.hessian`` against ``jax.hessian``) on each worker's shard
    and on the pooled data, at the start and at a point away from the
    saddle: rtol 1e-5 plus an atol of 1e-5 · max|·| for entries that cancel
    to near zero."""
    jp = _ref_problem()
    tp = _port_problem(jp)
    assert (tp.kind, tp.dim, tp.m_workers) == ("matrix_factor", 20, 10)
    # the dim is w0's (d·r), not X's last axis; with no w0 the start would
    # be the saddle itself, so it must be given
    with pytest.raises(SpecError, match="w0"):
        Problem.from_numpy(SPEC, "matrix_factor", X_workers=jp.X_workers,
                           y_workers=jp.y_workers, device="cpu")
    rng = np.random.default_rng(3)
    points = [np.asarray(jp.w0),
              (0.5 * rng.standard_normal(20)).astype(np.float32)]
    jgrad = jax.jit(jax.grad(jax_factor_loss))
    jhess = jax.jit(jax.hessian(jax_factor_loss))
    shards = [(np.asarray(jp.X_workers[i]), tp.X_workers[i])
              for i in range(2)] + [(np.asarray(jp.X_full), tp.X_full)]
    for w in points:
        wt = torch.from_numpy(w.copy())
        for Xj, Xt in shards:
            np.testing.assert_allclose(float(factor_loss(wt, Xt, None)),
                                       float(jax_factor_loss(w, Xj, None)),
                                       rtol=1e-5)
            for mine, ref in ((grad(factor_loss)(wt, Xt, None),
                               jgrad(w, Xj, None)),
                              (hessian(factor_loss)(wt, Xt, None),
                               jhess(w, Xj, None))):
                ref = np.asarray(ref)
                np.testing.assert_allclose(
                    mine.numpy(), ref, rtol=1e-5,
                    atol=1e-5 * float(np.abs(ref).max()))


def test_saddle_value_and_the_strict_saddle():
    """``saddle_value`` is the loss at U = 0; the Hessian there has
    λ_min < −1, equal to the reference's within rtol 1e-5."""
    jp = _ref_problem()
    tp = _port_problem(jp)
    zero = torch.zeros(20)
    np.testing.assert_allclose(float(factor_loss(zero, tp.X_full, None)),
                               jp.saddle_value, rtol=1e-6)
    assert tp.saddle_value == jp.saddle_value
    lam = float(torch.linalg.eigvalsh(
        hessian(factor_loss)(zero, tp.X_full, None))[0])
    ref_lam = float(jnp.linalg.eigvalsh(
        jax.hessian(jax_factor_loss)(jnp.zeros(20), jp.X_full, None))[0])
    assert lam < -1.0
    np.testing.assert_allclose(lam, ref_lam, rtol=1e-5)
    # the start lies next to the saddle, not on it
    assert 0 < float(torch.linalg.vector_norm(tp.w0)) < 1e-2


def test_first_round_solve_runs_to_its_cap_as_the_reference_does():
    """Algorithm 2 in the first round of the matrix-factor run (the
    reference's arrays, each worker's g and H at w0 beside the saddle):
    the port's plain solve ends within 1e-4 of the reference's
    ``solve_cubic_gd`` (‖s‖ ≈ 3).  The residual stalls at its float32
    floor, about the tolerance of 1e-6, so the reference runs all 10
    workers to the cap of 500 iterations and the port 7 of them: where a
    worker stops is a matter of rounding.  The reference's counts come
    from its loop with a counter carried along, which must return the
    reference's s bit for bit."""
    jp = _ref_problem()
    tp = _port_problem(jp)
    cfg = ExperimentSpec(problem=SPEC, m_workers=M_WORKERS, M=10.0,
                         seed=0).to_newton_config()
    kw = dict(M=cfg.M, gamma=cfg.gamma, tol=cfg.solver_tol,
              max_iters=cfg.solver_iters)
    per_worker = torch.func.vmap
    g = per_worker(grad(factor_loss), (None, 0, None))(tp.w0, tp.X_workers,
                                                       None)
    H = per_worker(hessian(factor_loss), (None, 0, None))(
        tp.w0, tp.X_workers, None)
    s, iters = cubic_solve_plain(g, H, torch.zeros_like(g),
                                 default_lr(H, cfg.M, cfg.gamma), **kw)
    X, w0 = jnp.asarray(jp.X_workers), jnp.asarray(jp.w0)
    jg = jax.vmap(jax.grad(jax_factor_loss), (None, 0, None))(w0, X, None)
    jH = jax.vmap(jax.hessian(jax_factor_loss), (None, 0, None))(w0, X, None)
    js = jax.vmap(lambda a, b: jax_solve_cubic_gd(a, b, **kw))(jg, jH)
    js_counted, jiters = jax.vmap(
        lambda a, b: _reference_loop_counted(a, b, **kw))(jg, jH)
    np.testing.assert_array_equal(np.asarray(js_counted).view(np.int32),
                                  np.asarray(js).view(np.int32))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-4)
    assert np.asarray(jiters).tolist() == [cfg.solver_iters] * M_WORKERS
    assert int((iters == cfg.solver_iters).sum()) == 7


def _reference_loop_counted(g, H, *, M, gamma, tol, max_iters):
    """``repro.core.cubic.solve_cubic_gd``'s loop, its default step
    included, returning its iteration count beside s."""
    lr = 1.0 / (gamma * (jnp.linalg.norm(H, ord="fro") + M * gamma) + 1e-8)

    def cond(state):
        it, s, G = state
        return jnp.logical_and(jnp.linalg.norm(G) > tol, it < max_iters)

    def body(state):
        it, s, G = state
        s = s - lr * G
        G = g + gamma * (H @ s) + 0.5 * M * gamma**2 * jnp.linalg.norm(s) * s
        return it + 1, s, G

    it, s, _ = jax.lax.while_loop(cond, body, (0, jnp.zeros_like(g), g))
    return s, it


def test_attack_free_run_matches_reference():
    """``benchmarks/saddle_escape.py``'s Newton arm (norm_trim at β = 0.1,
    no attack), 15 rounds in both packages over the reference's arrays:
    the per-round loss within rtol 1e-4 (atol 1e-6 where it nears its
    minimum) and the final UUᵀ within an atol of 1e-4 (U itself is only
    defined up to U → UQ)."""
    jspec = JaxSpec(problem=SPEC, m_workers=M_WORKERS, M=10.0, eta=1.0,
                    aggregator="norm_trim:0.1", seed=0)
    jexp = jspec.build()
    jw, jhist = jexp.run(15)
    exp = ExperimentSpec.from_dict(jspec.to_dict()).build(
        device="cpu", problem=_port_problem(jexp.problem))
    tw, thist = exp.run(15)
    np.testing.assert_allclose(thist["loss"], jhist["loss"], rtol=1e-4,
                               atol=1e-6)
    U, jU = tw.reshape(10, 2).numpy(), np.asarray(jw).reshape(10, 2)
    np.testing.assert_allclose(U @ U.T, jU @ jU.T, atol=1e-4)
    for key in ("uplink_bits", "downlink_bits", "bits_cumulative",
                "saddle_escape_step"):
        assert thist[key] == jhist[key], key
    assert thist["loss"][-1] < 0.05 * exp.problem.saddle_value


def _escape_run(aggregator, attack, rounds=15):
    exp = ExperimentSpec(problem=SPEC, m_workers=M_WORKERS, M=10.0,
                         aggregator=aggregator, attack=attack, alpha=0.2,
                         seed=0).build(device="cpu", problem=_port_problem())
    _, hist = exp.run(rounds)
    return hist, exp.problem.saddle_value


@pytest.mark.parametrize("agg", RULES)
@pytest.mark.parametrize("attack", ["saddle", "gaussian"])
def test_registry_aggregators_escape_saddle_under_attack(agg, attack):
    """Each robust rule escapes the strict saddle at α = 0.2 under the
    colluding saddle attack and under Gaussian noise, over the reference's
    arrays with the port's own attack draws at seed 0."""
    hist, saddle = _escape_run(agg, attack)
    assert all(np.isfinite(hist["loss"]))
    assert hist["loss"][-1] < ESCAPE * saddle
    assert hist["saddle_escape_step"] is not None


def test_mean_is_defeated_by_the_attacks_the_rules_survive():
    """The contrast: the non-robust mean stays above the escape line under
    the colluding attack at strength 20."""
    hist, saddle = _escape_run("mean", "saddle:20.0")
    assert hist["loss"][-1] > ESCAPE * saddle


def test_port_twin_builds_runs_and_escapes():
    """The port's own matrix-factor data (drawn from its generator) has the
    reference's shapes, starts next to its saddle, and escapes it under
    norm_trim with no attack."""
    jp = _ref_problem()
    tp = make_problem(SPEC, M_WORKERS, seed=0, device="cpu")
    assert (tp.kind, tp.dim) == (jp.kind, jp.dim)
    for name in ("X_workers", "y_workers", "w0", "X_full", "y_full"):
        assert tuple(getattr(tp, name).shape) == \
            tuple(getattr(jp, name).shape), name
    assert not tp.y_workers.any()
    np.testing.assert_allclose(
        tp.saddle_value, float(factor_loss(torch.zeros(20), tp.X_full, None)),
        rtol=1e-6)
    again = make_problem(SPEC, M_WORKERS, seed=0, device="cpu")
    assert torch.equal(again.X_workers, tp.X_workers)
    assert torch.equal(again.w0, tp.w0)
    exp = ExperimentSpec(problem=SPEC, m_workers=M_WORKERS, M=10.0,
                         aggregator="norm_trim:0.3").build(device="cpu")
    w, hist = exp.run(15)
    assert tuple(w.shape) == (20,) and bool(torch.isfinite(w).all())
    assert hist["loss"][-1] < ESCAPE * exp.problem.saddle_value


def test_quickstart_spec_reaches_its_accuracy():
    """``examples/quickstart.py`` in the port: synthetic logistic
    regression over 20 workers, 20 % of them adding N(0, 50²) noise,
    norm_trim at α + 2/m, 12 rounds, accuracy above 0.85."""
    m, alpha = 20, 0.2
    exp = ExperimentSpec(problem="synthetic-logistic:8000:60", m_workers=m,
                         M=10.0, eta=1.0,
                         aggregator=f"norm_trim:{alpha + 2.0 / m}",
                         attack="gaussian:50.0",
                         alpha=alpha).build(device="cpu")
    w, hist = exp.run(n_steps=12)
    assert hist["rounds"] == 12 and all(np.isfinite(hist["loss"]))
    assert exp.problem.accuracy(w) > 0.85
