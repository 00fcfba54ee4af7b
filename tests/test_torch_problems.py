"""The port's losses and local derivatives against the reference's, on a
reference worker shard; the port's data twins and problem catalog."""
import jax
import numpy as np
import pytest
import torch
from torch.func import grad, hessian, vmap

from repro.api import make_problem as jax_make_problem
from repro.api.problems import logistic_loss as jax_logistic_loss
from repro.api.problems import robust_regression_loss as jax_robust_loss
from repro_torch import interop
from repro_torch.api import SpecError, make_problem, problem_dim
from repro_torch.api.problems import logistic_loss, robust_regression_loss

torch.set_num_threads(1)

PAIRS = {
    "synthetic-logistic:400:12": (jax_logistic_loss, logistic_loss),
    "synthetic-regression:400:12": (jax_robust_loss, robust_regression_loss),
}


@pytest.mark.parametrize("spec", sorted(PAIRS))
def test_local_derivatives_match_reference(spec):
    """jax.grad / jax.hessian per worker against torch.func's grad and
    hessian, vmapped over the worker axis: rtol 1e-5 (plus an atol of 1e-7
    for entries that cancel to ~0)."""
    jloss, tloss = PAIRS[spec]
    jp = jax_make_problem(spec, 4, 0)
    tp = interop.problem_from_reference(jp, device="cpu")
    w = np.random.default_rng(1).standard_normal(12).astype(np.float32) * 0.3
    wt = torch.from_numpy(w)
    X, y = tp.X_workers, tp.y_workers
    jgrad, jhess = jax.jit(jax.grad(jloss)), jax.jit(jax.hessian(jloss))
    for i in range(X.shape[0]):
        Xi, yi = np.asarray(jp.X_workers[i]), np.asarray(jp.y_workers[i])
        np.testing.assert_allclose(
            float(tloss(wt, X[i], y[i])), float(jloss(w, Xi, yi)), rtol=1e-5)
        jg = np.asarray(jgrad(w, Xi, yi))
        jh = np.asarray(jhess(w, Xi, yi))
        np.testing.assert_allclose(grad(tloss)(wt, X[i], y[i]).numpy(), jg,
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(hessian(tloss)(wt, X[i], y[i]).numpy(), jh,
                                   rtol=1e-5, atol=1e-7)
    # batched over workers, as the runtime computes them
    G = vmap(grad(tloss), in_dims=(None, 0, 0))(wt, X, y)
    Hs = vmap(hessian(tloss), in_dims=(None, 0, 0))(wt, X, y)
    for i in range(X.shape[0]):
        np.testing.assert_allclose(G[i].numpy(),
                                   grad(tloss)(wt, X[i], y[i]).numpy(),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(Hs[i].numpy(),
                                   hessian(tloss)(wt, X[i], y[i]).numpy(),
                                   rtol=1e-5, atol=1e-7)


def test_logistic_loss_keeps_log1p_exp_literally():
    """Large margins: softplus linearises above 20, log1p(exp) does not;
    the port must give the reference's number."""
    X = np.array([[30.0, -25.0], [1.0, 2.0]], np.float32)
    y = np.array([0.0, 1.0], np.float32)
    w = np.array([1.0, -0.5], np.float32)
    ref = float(jax_logistic_loss(w, X, y))
    out = float(logistic_loss(*map(torch.from_numpy, (w, X, y))))
    np.testing.assert_allclose(out, ref, rtol=1e-6)


@pytest.mark.parametrize("spec,m", [("a9a-logistic", 20),
                                    ("synthetic-regression:1000:30", 7)])
def test_problem_twins_have_the_reference_shapes(spec, m):
    jp = jax_make_problem(spec, m, 0)
    tp = make_problem(spec, m, seed=0, device="cpu")
    assert tp.kind == jp.kind and tp.dim == jp.dim == problem_dim(spec)
    for name in ("X_workers", "y_workers", "w0", "X_full", "y_full",
                 "X_test", "y_test"):
        ref = getattr(jp, name)
        out = getattr(tp, name)
        assert (out is None) == (ref is None), name
        if out is not None:
            assert tuple(out.shape) == tuple(ref.shape), name
            assert out.dtype == torch.float32 and torch.isfinite(out).all()
    # deterministic from the seed, and a different seed gives other data
    again = make_problem(spec, m, seed=0, device="cpu")
    assert torch.equal(again.X_workers, tp.X_workers)
    other = make_problem(spec, m, seed=1, device="cpu")
    assert not torch.equal(other.X_workers, tp.X_workers)


def test_problem_catalog_rejects_and_defers():
    with pytest.raises(SpecError):
        problem_dim("no-such-problem")
    # matrix-factor is ported: its dim is d·r, as the reference's
    assert problem_dim("matrix-factor:10:2") == 20
    assert problem_dim("matrix-factor:12:3") == 36
    assert problem_dim("matrix-factor") == 20
    with pytest.raises(SpecError, match="integers"):
        problem_dim("matrix-factor:ten")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_problem("quadratic:8", 4, device="cpu")
