"""The closed-form worker Hessians of the catalog's two losses against
``jax.hessian`` (the reference's) and ``vmap(hessian)`` (the port's path
for any other loss), per worker, on a w8a shard and on a d = 4352 shard of
64 rows; rtol 1e-5, atol 1e-7.

The comparison with the autodiff Hessians is made where the runs form
Hessians: at w0 = 0 and at iterates of norm 0.1, which covers the first
rounds of every CPU run.  Farther out (‖w‖ of order ‖w*‖) the float32
rounding of a 64-term sum with terms of both signs reaches 2e-7 on entries
near 0, past the atol, for ``jax.hessian`` as for the closed form.  There
both are held to the float64 Hessian within the rounding bound of a float32
dot product, n·2⁻²⁴·(|X|ᵀ·|diag(c)|·|X|)/n, beside the rtol."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import hessian, vmap

from repro.api.problems import make_problem as jax_make_problem
from repro_torch.api.problems import (
    HESSIANS,
    logistic_hessians,
    logistic_loss,
    robust_regression_hessians,
    robust_regression_loss,
)
from repro_torch.core import DistributedCubicNewton, NewtonConfig

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-7
# (problem, m): a w8a shard (2487 rows, d = 300) and a d = 4352 shard of 64
# rows, for each loss
PROBLEMS = [("w8a-logistic", 20), ("w8a-robust", 20),
            ("synthetic-logistic:256:4352", 4),
            ("synthetic-regression:256:4352", 4)]
_CACHE = {}


def _shard(spec, m):
    """The reference's data for ``spec``: workers 0–1 (X, y) as numpy, the
    loss kind, the reference's Hessian (``jax.hessian`` of its loss) and a
    scale for far iterates (‖w*‖, or 1 without a w*)."""
    if spec not in _CACHE:
        p = jax_make_problem(spec, m, seed=0)
        far = 1.0 if p.w_star is None else float(np.linalg.norm(p.w_star))
        _CACHE[spec] = (np.asarray(p.X_workers[:2]),
                        np.asarray(p.y_workers[:2]), p.kind,
                        jax.jit(jax.hessian(p.loss_fn)), far)
    return _CACHE[spec]


def _iterate(d, norm, seed):
    u = np.random.default_rng(seed).standard_normal(d)
    return (u * norm / np.linalg.norm(u)).astype(np.float32)


def _closed(kind, X, y, w):
    fn = logistic_hessians if kind == "logistic" else robust_regression_hessians
    return fn(torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w))


@pytest.mark.parametrize("spec,m", PROBLEMS)
@pytest.mark.parametrize("norm", [0.0, 0.1])
def test_closed_form_matches_jax_hessian(spec, m, norm):
    X, y, kind, jax_hessian, _ = _shard(spec, m)
    w = _iterate(X.shape[-1], norm, 1)
    H = _closed(kind, X, y, w).numpy()
    for i in range(X.shape[0]):
        want = jax_hessian(jnp.asarray(w), jnp.asarray(X[i]),
                           jnp.asarray(y[i]))
        np.testing.assert_allclose(H[i], np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("spec,m", PROBLEMS)
@pytest.mark.parametrize("norm", [0.0, 0.1])
def test_closed_form_matches_vmapped_hessian(spec, m, norm):
    """Against the port's generic path on worker 0 (its vmapped batch keeps
    an (m, d, n, d)-sized intermediate, so one worker at a time)."""
    X, y, kind, _, _ = _shard(spec, m)
    w = torch.from_numpy(_iterate(X.shape[-1], norm, 2))
    loss = logistic_loss if kind == "logistic" else robust_regression_loss
    H = _closed(kind, X[:1], y[:1], w.numpy())
    want = vmap(hessian(loss), in_dims=(None, 0, 0))(
        w, torch.from_numpy(X[:1]), torch.from_numpy(y[:1]))
    np.testing.assert_allclose(H.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("spec,m", PROBLEMS)
def test_closed_form_and_jax_hessian_match_float64_far_from_w0(spec, m):
    X, y, kind, jax_hessian, far = _shard(spec, m)
    n = X.shape[1]
    w = _iterate(X.shape[-1], far, 3)
    H64 = _closed(kind, X.astype(np.float64), y.astype(np.float64),
                  w.astype(np.float64)).numpy()
    # the size of each entry's terms, |X|ᵀ·|diag(c)|·|X|/n, with the
    # curvature weights c of the two losses
    X64 = torch.from_numpy(X).double()
    z = X64 @ torch.from_numpy(w).double()
    if kind == "logistic":
        c = torch.sigmoid(z) * torch.sigmoid(-z)
    else:
        a = 0.5 * (torch.from_numpy(y).double() - z) ** 2
        c = (1.0 - a).abs() / (1.0 + a) ** 2
    size = (torch.bmm(X64.abs().transpose(1, 2) * c[:, None, :], X64.abs())
            / n).numpy()
    bound = RTOL * np.abs(H64) + n * 2.0 ** -24 * size
    H = _closed(kind, X, y, w).numpy()
    assert (np.abs(H - H64) <= bound).all()
    for i in range(X.shape[0]):
        Hj = np.asarray(jax_hessian(jnp.asarray(w), jnp.asarray(X[i]),
                                    jnp.asarray(y[i])))
        assert (np.abs(Hj - H64[i]) <= bound[i]).all()


def test_runtime_takes_the_closed_form_for_catalog_losses_only():
    X, y, _, _, _ = _shard("w8a-robust", 20)
    X, y = torch.from_numpy(X[:, :200]), torch.from_numpy(y[:, :200])
    w = torch.from_numpy(_iterate(X.shape[-1], 0.1, 4))
    assert set(HESSIANS) == {logistic_loss, robust_regression_loss}
    closed = DistributedCubicNewton(robust_regression_loss, NewtonConfig(),
                                    device="cpu")

    def custom(w, X, y):       # the same loss, unknown to the catalog
        return robust_regression_loss(w, X, y)

    generic = DistributedCubicNewton(custom, NewtonConfig(), device="cpu")
    Hc = closed._worker_hessians(w, X, y)
    assert torch.equal(Hc, robust_regression_hessians(X, y, w))
    np.testing.assert_allclose(Hc.numpy(),
                               generic._worker_hessians(w, X, y).numpy(),
                               rtol=RTOL, atol=ATOL)
