"""The paper's comparison rules -- krum, the coordinate-wise trimmed mean and
median -- and their kernel heads, against the reference on the CPU.

The reference's Pallas kernels run in interpret mode, as its own tests run
them; the port's wrappers take their plain versions on CPU tensors.
Tolerances: the sort and the keep masks are exact; medians and trimmed means
rtol 1e-6 and atol 1e-7 (means summed in another order); krum scores rtol
2e-5 (distance sums in another order) and exact on integer payloads, whose
sums are exact in float32.  Krum's selection is held only where the scores
decide it: with k_near = 1, mutual nearest neighbours score the same by
construction, and which one wins then rests on rounding."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as ref_agg
from repro.kernels.ref import krum_scores_ref
from repro.kernels.robust_agg import (
    coordinate_median_fused as ref_median_fused,
    krum_scores_fused as ref_krum_scores_fused,
    krum_select_fused as ref_krum_select_fused,
    sort_workers_fused as ref_sort_workers_fused,
    trimmed_mean_fused as ref_trimmed_mean_fused,
)
from repro_torch.api import ExperimentSpec, logistic_loss, make_problem
from repro_torch.core import DistributedCubicNewton, NewtonConfig
from repro_torch.core import aggregation as agg
from repro_torch.kernels import (
    LAUNCHES,
    coordinate_median_fused,
    krum_scores,
    krum_select_fused,
    sort_workers,
    trimmed_mean_fused,
)
from repro_torch.kernels.robust_agg import krum_k_near

torch.set_num_threads(1)

SHAPES = [(3, 7), (4, 30), (9, 64), (12, 100), (20, 300)]


def _stack(m, d, seed, kind):
    """An (m, d) float32 stack: ``normal`` (rows of different scales),
    ``ties`` (few distinct values, zeros of both signs), ``special``
    (``ties`` plus ±inf and one NaN column), ``integer`` (small integers)."""
    rng = np.random.default_rng(seed)
    if kind == "normal":
        x = rng.standard_normal((m, d)) * rng.uniform(0.01, 3.0, (m, 1))
    elif kind == "integer":
        x = rng.integers(-5, 6, (m, d)).astype(np.float64)
    else:
        x = rng.integers(-2, 3, (m, d)).astype(np.float64)
        # negating a zero gives -0.0: both signs of zero in every column
        x = np.where(rng.random((m, d)) < 0.5, -x, x)
        if kind == "special":
            x[rng.random((m, d)) < 0.1] = np.inf
            x[rng.random((m, d)) < 0.1] = -np.inf
            x[:, d // 2] = np.where(rng.random(m) < 0.5, np.nan, 1.0)
    return x.astype(np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("kind", ["normal", "ties", "special"])
@pytest.mark.parametrize("m,d", SHAPES)
def test_sort_workers_matches_reference(m, d, kind):
    """Bitwise equal to ``jnp.sort``: ±0 in worker order, NaN last.  The
    reference's bitonic kernel agrees on values only, since it is not
    stable; it is held on the inputs without NaN."""
    x = _stack(m, d, m * 100 + d, kind)
    out = sort_workers(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        _bits(out), _bits(jnp.sort(jnp.asarray(x), axis=0)))
    if kind != "special":
        np.testing.assert_array_equal(
            out, np.asarray(ref_sort_workers_fused(jnp.asarray(x))))


@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("trim_frac", [0.0, 0.2, 0.4])
@pytest.mark.parametrize("m", [3, 4, 9, 12])
def test_trimmed_mean_matches_reference(m, trim_frac, kind):
    x = _stack(m, 64, m, kind)
    ref = np.asarray(ref_agg.trimmed_mean(jnp.asarray(x), trim_frac))
    np.testing.assert_allclose(
        np.asarray(ref_trimmed_mean_fused(jnp.asarray(x), trim_frac)), ref,
        rtol=1e-6, atol=1e-7)
    for fn in (agg.trimmed_mean, trimmed_mean_fused):
        np.testing.assert_allclose(fn(torch.from_numpy(x), trim_frac).numpy(),
                                   ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("m", [2, 3, 6, 11, 20])
def test_coordinate_median_matches_reference(m, kind):
    """Odd and even m: for even m the midpoint of the two middle values,
    as ``jnp.median`` takes it (``torch.median`` would take the lower)."""
    x = _stack(m, 80, 7 + m, kind)
    ref = np.asarray(ref_agg.coordinate_median(jnp.asarray(x)))
    np.testing.assert_allclose(
        np.asarray(ref_median_fused(jnp.asarray(x))), ref,
        rtol=1e-6, atol=1e-7)
    for fn in (agg.coordinate_median, coordinate_median_fused):
        np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(), ref,
                                   rtol=1e-6, atol=1e-7)
    if m % 2 == 0 and kind == "normal":
        lower = torch.median(torch.from_numpy(x), dim=0).values.numpy()
        assert not np.allclose(lower, ref)


@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("m", [3, 4, 9, 20])
def test_contribution_keep_matches_reference_exactly(m, kind):
    """The soft keep of the trimmed-mean bands and the median band."""
    x = _stack(m, 90, 50 + m, kind)
    k = min(int(round(0.25 * m)), (m - 1) // 2)
    for lo, hi in ((k, m - k), ((m - 1) // 2, m // 2 + 1), (0, m)):
        ref = np.asarray(ref_agg.contribution_keep(jnp.asarray(x), lo, hi))
        out = agg.contribution_keep(torch.from_numpy(x), lo, hi)
        assert out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("n_byz", [1, 2])
@pytest.mark.parametrize("m,d", [(4, 64), (6, 600), (10, 1024), (13, 1500),
                                 (20, 300)])
def test_krum_scores_match_reference(m, d, n_byz):
    x = _stack(m, d, m * 1000 + d, "normal")
    ref = krum_scores_ref(x, n_byz)
    np.testing.assert_allclose(
        np.asarray(ref_krum_scores_fused(jnp.asarray(x), n_byz)), ref,
        rtol=2e-5)
    np.testing.assert_allclose(krum_scores(torch.from_numpy(x), n_byz).numpy(),
                               ref, rtol=2e-5)


@pytest.mark.parametrize("m,d", [(8, 700), (20, 300)])
def test_krum_scores_exact_on_integer_payloads(m, d):
    x = _stack(m, d, 11, "integer")
    ref = np.asarray(krum_scores_ref(x, 2), np.float32)
    np.testing.assert_array_equal(
        np.asarray(ref_krum_scores_fused(jnp.asarray(x), 2)), ref)
    np.testing.assert_array_equal(
        krum_scores(torch.from_numpy(x), 2).numpy(), ref)


def test_krum_selection_matches_reference_where_the_scores_decide():
    checked = 0
    for seed in range(8):
        for m in (4, 5, 7, 10, 12):
            for n_byz in (1, 2):
                x = _stack(m, 40, seed * 97 + m, "normal")
                best = np.sort(np.asarray(krum_scores_ref(x, n_byz)))[:2]
                if krum_k_near(m, n_byz) == 1 and \
                        best[1] - best[0] <= 2e-5 * abs(best[0]):
                    continue
                want = int(ref_agg.krum_select(jnp.asarray(x), n_byz))
                assert want == int(ref_krum_select_fused(jnp.asarray(x),
                                                         n_byz))
                for fn in (agg.krum_select, krum_select_fused):
                    assert int(fn(torch.from_numpy(x), n_byz)) == want
                checked += 1
    assert checked >= 50


def test_kernel_wrappers_check_their_inputs_and_count_no_cpu_launch():
    x = torch.zeros(4, 6)
    before = dict(LAUNCHES)
    sort_workers(x)
    krum_scores(x, 1)
    assert LAUNCHES == before
    for fn in (sort_workers, lambda t: krum_scores(t, 1)):
        with pytest.raises(TypeError, match="float32"):
            fn(x.double())
        with pytest.raises(ValueError, match=r"\(m, d\)"):
            fn(torch.zeros(6))
        with pytest.raises(ValueError, match="cuda or cpu"):
            fn(torch.zeros(4, 6, device="meta"))
    with pytest.raises(ValueError, match="n_byz"):
        krum_scores(x, -1)


@pytest.mark.parametrize("aggregator", ["krum_kernel:4",
                                        "trimmed_mean_kernel:0.25",
                                        "coordinate_median_kernel"])
def test_w8a_kernel_specs_validate_and_need_the_card(monkeypatch, aggregator):
    """The three kernel heads at the paper's α = 0.2, m = 20 strengths pass
    validation; built with no card they raise, never run on the CPU."""
    spec = ExperimentSpec(problem="w8a-logistic", m_workers=20, alpha=0.2,
                          attack="gaussian", compressor="topk_kernel:0.1",
                          aggregator=aggregator)
    spec.validate()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spec.build()


@pytest.mark.parametrize("aggregator", ["krum:2", "trimmed_mean:0.25",
                                        "coordinate_median_kernel"])
def test_sparse_center_stays_off_for_rules_without_a_sparse_path(aggregator):
    """``auto`` keeps the dense center for these rules even where the
    uplink could hand over payloads; demanding the sparse center raises."""
    p = make_problem("synthetic-logistic:200:8", 8, device="cpu")
    base = dict(compressor="topk:0.25", error_feedback="none",
                aggregator=aggregator)
    algo = DistributedCubicNewton(logistic_loss, NewtonConfig(**base),
                                  device="cpu")
    algo.step(p.w0, p.X_workers, p.y_workers)
    assert algo.uplink.supports_sparse_receive
    assert algo._use_sparse_center is False
    algo = DistributedCubicNewton(
        logistic_loss, NewtonConfig(**base, sparse_center=True), device="cpu")
    with pytest.raises(ValueError, match="sparse_center=True needs"):
        algo.step(p.w0, p.X_workers, p.y_workers)
