"""Parity of the port's cubic solve (plain PyTorch, CPU) with the
reference's Pallas kernel (interpret mode off-TPU) and solvers.

Inputs are made with numpy from a seed and given to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cubic import solve_cubic_exact as jax_solve_cubic_exact
from repro.core.cubic import solve_cubic_gd as jax_solve_cubic_gd
from repro.kernels.cubic_step import cubic_solve_fused as jax_cubic_solve_fused
from repro.kernels.cubic_step import cubic_step as jax_cubic_step
from repro_torch.core import (
    cubic_model_value,
    cubic_residual,
    solve_cubic_exact,
    solve_cubic_gd,
)
from repro_torch.kernels import cubic_solve, cubic_solve_fused, cubic_step

torch.set_num_threads(1)


def _problem(d, seed, m=None):
    """A symmetric indefinite H (a saddle direction, as near the paper's
    saddles) and a gradient g, float32."""
    rng = np.random.default_rng(seed)
    lead = () if m is None else (m,)
    A = rng.standard_normal(lead + (d, d)).astype(np.float32)
    H = (A + np.swapaxes(A, -1, -2)) / (2 * np.sqrt(d))
    g = rng.standard_normal(lead + (d,)).astype(np.float32)
    return g.astype(np.float32), H.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("d", [8, 40, 123])
def test_cubic_step_matches_reference_kernel(d):
    g, H = _problem(d, d)
    s = (0.1 * np.random.default_rng(d + 1).standard_normal(d)).astype(np.float32)
    ref = jax_cubic_step(jnp.asarray(s), jnp.asarray(g), jnp.asarray(H),
                         M=10.0, gamma=1.0, lr=1e-2)
    out = cubic_step(_t(s), _t(g), _t(H), 1e-2, M=10.0, gamma=1.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("d", [8, 40, 123])
def test_cubic_solve_fused_matches_reference_kernel(d):
    g, H = _problem(d, 100 + d)
    ref = jax_cubic_solve_fused(jnp.asarray(g), jnp.asarray(H), n_iters=30)
    out = cubic_solve_fused(_t(g), _t(H), n_iters=30)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_batched_solve_matches_reference_solve_cubic_gd():
    """The reference vmaps Algorithm 2's while_loop over workers; the port
    batches them.  atol 1e-5: one iteration more or less at the tol
    boundary moves s by at most lr·tol."""
    m, d = 4, 40
    g, H = _problem(d, 7, m=m)
    g[1] *= 1e-3          # a worker that stops after few iterations
    ref = np.stack([np.asarray(jax_solve_cubic_gd(
        jnp.asarray(g[i]), jnp.asarray(H[i]), M=10.0, gamma=1.0, tol=1e-6,
        max_iters=500)) for i in range(m)])
    out = solve_cubic_gd(_t(g), _t(H), M=10.0, gamma=1.0, tol=1e-6,
                         max_iters=500)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_solve_stops_each_worker_on_its_own_condition():
    """A stationary worker does no iteration, a converging one stops early,
    and the others run to the cap without being held by the rest."""
    m, d = 3, 16
    g, H = _problem(d, 3, m=m)
    g[0] = 0.0
    s, iters = cubic_solve(_t(g), _t(H), M=10.0, gamma=1.0, tol=1e-6,
                           max_iters=500)
    assert iters[0].item() == 0 and torch.all(s[0] == 0)
    assert 0 < iters[1].item() < 500
    capped, capped_iters = cubic_solve(_t(g), _t(H), M=10.0, gamma=1.0,
                                       tol=1e-6, max_iters=5)
    assert capped_iters.tolist() == [0, 5, 5]
    alone = cubic_solve_fused(_t(g[2]), _t(H[2]), n_iters=5)
    np.testing.assert_allclose(capped[2].numpy(), alone.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_solve_cubic_exact_matches_reference():
    g, H = _problem(40, 11)
    ref = jax_solve_cubic_exact(jnp.asarray(g), jnp.asarray(H), M=10.0,
                                gamma=1.0)
    out = solve_cubic_exact(_t(g), _t(H), M=10.0, gamma=1.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    # the oracle is stationary and no worse than the Algorithm-2 solution
    assert cubic_residual(out, _t(g), _t(H)).item() < 1e-4
    gd = solve_cubic_gd(_t(g), _t(H), max_iters=4000)
    assert (cubic_model_value(out, _t(g), _t(H)).item()
            <= cubic_model_value(gd, _t(g), _t(H)).item() + 1e-5)
