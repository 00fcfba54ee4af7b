"""Algorithm 1 past the single-tile bounds, d = 4352 (the sharded top-k path
and, above 4096, the gridded sparse center), in the port against the
reference, built from the same spec over the same arrays on the CPU; and the
adaptive top-k schedule (``adaptive_topk_kernel``) that moves k between
rounds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExperimentSpec as JaxSpec
from repro_torch import interop
from repro_torch.api import ExperimentSpec
from repro_torch.compression import AdaptiveTopK

torch.set_num_threads(1)

BASE = dict(problem="synthetic-logistic:256:4352", m_workers=4,
            solver_iters=5, aggregator="norm_trim:0.4", alpha=0.25)
VARIANTS = {
    # top-k through the sharded path, no error feedback: the sparse center,
    # summed by the gridded path (d > 4096)
    "topk-sparse-center": dict(compressor="topk_kernel:0.1",
                               error_feedback="none",
                               attack="flipped_label"),
    # adaptive k over the sharded path, EF21, a dense center
    "adaptive-ef21": dict(compressor="adaptive_topk_kernel:0.05:0.5",
                          attack="negative:0.9"),
}
ROUNDS = 2


def _stepped_keeps(step, adapt, pooled_grad_norm, w, v, st):
    """Each round's keep mask from stepping a runtime by hand, feeding its
    adaptive schedule as ``run`` does."""
    keeps = []
    for _ in range(ROUNDS):
        w, v, st, info = step(w, v, st)
        keeps.append(np.asarray(info["keep"]))
        adapt(pooled_grad_norm(w), float(info["uplink_delta"]))
    return keeps


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_two_rounds_match_reference(variant):
    jspec = JaxSpec(**BASE, **VARIANTS[variant])
    jexp = jspec.build()
    jw, jhist = jexp.run(ROUNDS)
    spec = ExperimentSpec.from_dict(jspec.to_dict())
    exp = spec.build(device="cpu", problem=interop.problem_from_reference(
        jexp.problem, device="cpu"))
    tw, thist = exp.run(ROUNDS)

    sparse = variant.endswith("sparse-center")
    assert exp.algo._use_sparse_center is sparse
    assert jexp.algo._use_sparse_center is sparse
    assert set(thist) == set(jhist)
    for key in ("uplink_bits", "downlink_bits", "total_bits", "rounds",
                "bits_cumulative", "k_trajectory"):
        assert thist[key] == jhist[key], key
    if variant.startswith("adaptive"):
        assert thist["k_trajectory"][0] == 218   # k_min = round(0.05·4352)
    else:
        assert thist["k_trajectory"] == [None] * ROUNDS
    np.testing.assert_allclose(thist["loss"], jhist["loss"], rtol=1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5)

    # the keep masks, round by round, from fresh runtimes
    jalgo, jp = JaxSpec(**BASE, **VARIANTS[variant]).build().algo, jexp.problem
    jalgo._ensure_channels(jp.dim, jp.m_workers)
    keys = iter(jax.random.split(jax.random.PRNGKey(0), ROUNDS))
    Xf, yf = jp.X_workers.reshape(-1, jp.dim), jp.y_workers.reshape(-1)
    jkeeps = _stepped_keeps(
        lambda w, v, st: jalgo.step(w, jp.X_workers, jp.y_workers,
                                    next(keys), v, st),
        jalgo._maybe_adapt,
        lambda w: float(jnp.linalg.norm(jax.grad(jp.loss_fn)(w, Xf, yf))),
        jp.w0, jnp.zeros_like(jp.w0), jalgo.init_comm_state())
    texp = spec.build(device="cpu", problem=exp.problem)
    talgo, tp = texp.algo, texp.problem
    talgo._ensure_channels(tp.dim, tp.m_workers)
    tkeeps = _stepped_keeps(
        lambda w, v, st: talgo.step(w, tp.X_workers, tp.y_workers, None, v,
                                    st),
        talgo._maybe_adapt,
        lambda w: float(torch.linalg.vector_norm(torch.func.grad(
            tp.loss_fn)(w, tp.X_full, tp.y_full))),
        tp.w0, torch.zeros_like(tp.w0), talgo.init_comm_state())
    for jk, tk in zip(jkeeps, tkeeps):
        np.testing.assert_array_equal(tk, jk)


def test_measured_delta_pins_k_trajectory():
    """The reference's pin (tests/test_api.py): measured δ̂ below target
    doubles k at once (no patience window); at or above target the schedule
    holds."""
    comp = AdaptiveTopK(100, 5, 80, delta_target=0.6)
    ks = []
    for delta in (0.2, 0.3, 0.5, 0.7, 0.9, 0.9):
        comp.schedule_update(grad_norm=1.0, measured_delta=delta)
        ks.append(comp.k)
    assert ks == [10, 20, 40, 40, 40, 40]
    # wire cost follows the live k; the δ guarantee stays the k_min floor
    assert comp.wire_bits(100) == 40 * (32 + 7)
    assert comp.delta_bound(100) == pytest.approx(0.05)


def test_plateau_grows_and_fast_progress_shrinks_k():
    """The schedule's other two moves, as the reference makes them: a
    gradient-norm plateau over ``patience`` rounds doubles k; fast progress
    with δ̂ on target halves it."""
    comp = AdaptiveTopK(100, 5, 80, patience=2)
    for gn in (1.0, 0.99, 0.98):
        changed = comp.schedule_update(grad_norm=gn, measured_delta=0.9)
    assert changed and comp.k == 10
    for gn in (1.0, 0.5, 0.2):
        changed = comp.schedule_update(grad_norm=gn, measured_delta=0.9)
    assert changed and comp.k == 5
    with pytest.raises(ValueError):
        AdaptiveTopK(100, 10, 5)
