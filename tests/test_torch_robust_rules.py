"""The paper's comparison rules -- krum, the coordinate-wise trimmed mean and
median -- and their kernel heads, against the reference on the CPU.

The reference's Pallas kernels run in interpret mode, as its own tests run
them; the port's wrappers take their plain versions on CPU tensors.
Tolerances: the sort and the keep masks are exact; medians and trimmed means
rtol 1e-6 and atol 1e-7 (means summed in another order); krum scores rtol
2e-5 (distance sums in another order) and exact on integer payloads, whose
sums are exact in float32.  Krum's selection is held only where the scores
decide it: with k_near = 1, mutual nearest neighbours score the same by
construction, and which one wins then rests on rounding.

The kernels' launch plans (:func:`sort_plan`, :func:`krum_plan`) are plain
Python and are checked here: the tiles cover every column and every pair
once, the limits raise, and the shared memory fits a block.  The sort's
64-bit keys are mirrored in numpy (:func:`_sort_keys`): sorting by them
must give the stable sort's bits, ±0, NaN payloads and subnormals
included."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

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
from repro_torch.kernels import robust_agg
from repro_torch.kernels.robust_agg import (
    KRUM_MAX_M,
    KRUM_SCRATCH_MAX,
    SMEM_PER_BLOCK,
    SORT_MAX_M,
    krum_k_near,
    krum_plan,
    krum_scores_plain,
    krum_slices,
    krum_tiles,
    sort_plan,
)

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


def _sort_keys(x):
    """Numpy mirror of the keys ``csrc/sort_workers.cu`` sorts a column by:
    the value's orderable 32-bit word (±0 one word, every NaN one word above
    +inf) joined above the worker index."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    mag = u & 0x7FFFFFFF
    word = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    word = np.where(mag == 0, 0x80000000, word)
    word = np.where(mag > 0x7F800000, 0xFFFFFFFF, word)
    rows = np.arange(u.shape[0], dtype=np.uint64)[:, None]
    return (word.astype(np.uint64) << np.uint64(32)) | rows


def _sorted_by_keys(x):
    keys = _sort_keys(x)
    for col in keys.T:
        assert len(np.unique(col)) == len(col)  # unique: any sort is stable
    order = np.argsort(keys, axis=0, kind="quicksort")
    return np.take_along_axis(x, order, axis=0)


def _stable_sort_bits(x):
    return torch.sort(torch.from_numpy(x), dim=0,
                      stable=True).values.numpy().view(np.uint32)


@pytest.mark.parametrize("kind", ["ties", "special"])
@pytest.mark.parametrize("m,d", SHAPES)
def test_sort_keys_give_the_stable_sort(m, d, kind):
    x = _stack(m, d, m * 7 + d, kind)
    np.testing.assert_array_equal(_sorted_by_keys(x).view(np.uint32),
                                  _stable_sort_bits(x))


# ±0, ±inf, NaNs of several payloads and both signs, subnormals, and a few
# normal values that tie
_SPECIAL_BITS = [0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000,
                 0x7F800001, 0xFFC00001, 0x7FFFFFFF, 0xFFFFFFFF, 0x00000001,
                 0x80000001, 0x007FFFFF, 0x807FFFFF, 0x3F800000, 0xBF800000,
                 0x3F800001, 0x00800000]


@settings(max_examples=60, deadline=None)
@given(st.integers(min_value=1, max_value=40),
       st.integers(min_value=1, max_value=5),
       st.data())
def test_sort_keys_give_the_stable_sort_property(m, d, data):
    bits = data.draw(st.lists(
        st.one_of(st.sampled_from(_SPECIAL_BITS),
                  st.integers(min_value=0, max_value=2**32 - 1)),
        min_size=m * d, max_size=m * d))
    x = np.array(bits, np.uint32).reshape(m, d).view(np.float32)
    np.testing.assert_array_equal(_sorted_by_keys(x).view(np.uint32),
                                  _stable_sort_bits(x))
    np.testing.assert_array_equal(
        sort_workers(torch.from_numpy(x)).numpy().view(np.uint32),
        _stable_sort_bits(x))


_PLAN_SHAPES = [(1, 1), (3, 1), (20, 300), (33, 513), (256, 4096),
                (300, 300), (32, 131072), (128, 1_000_000), (1025, 7),
                (2048, 512), (16384, 8)]


@pytest.mark.parametrize("m,d", _PLAN_SHAPES)
def test_sort_plan_covers_every_column_within_a_block(m, d):
    plan = sort_plan(m, d)
    assert plan.pad >= m and plan.pad & (plan.pad - 1) == 0
    assert plan.per_thread * plan.lanes == plan.pad
    assert plan.ctas * plan.tile >= d > (plan.ctas - 1) * plan.tile
    assert 32 <= plan.threads <= 1024 and plan.threads % 32 == 0
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    assert plan.smem_bytes >= 4 * m * plan.tile


@pytest.mark.parametrize("m,d", _PLAN_SHAPES)
def test_krum_plan_covers_every_pair_once_within_a_block(m, d):
    plan = krum_plan(m, d)
    tiles = krum_tiles(plan)
    assert len(tiles) == len(set(tiles)) == plan.tiles
    covered = 0
    seen = np.zeros((m, m), np.int8) if m <= 4096 else None
    for i0, j0 in tiles:
        assert i0 <= j0 < m and i0 % plan.tile == j0 % plan.tile == 0
        i1, j1 = min(i0 + plan.tile, m), min(j0 + plan.tile, m)
        block = np.ones((i1 - i0, j1 - j0), np.int8)
        if i0 == j0:
            block = np.triu(block)  # a diagonal tile: its pairs with i ≤ j
        covered += int(block.sum())
        if seen is not None:
            seen[i0:i1, j0:j1] += block
    assert covered == m * (m + 1) // 2
    if seen is not None:
        np.testing.assert_array_equal(seen, np.triu(np.ones((m, m), np.int8)))
    slices = krum_slices(plan)
    assert len(slices) == plan.slices and slices[0][0] == 0
    assert slices[-1][1] == d
    assert all(a < b or d == 0 for a, b in slices)
    assert all(b == a2 for (_, b), (a2, _) in zip(slices, slices[1:]))
    assert plan.pair_smem <= SMEM_PER_BLOCK
    assert plan.select_smem <= SMEM_PER_BLOCK
    assert plan.scratch_bytes <= KRUM_SCRATCH_MAX
    assert plan.fused == (plan.ctas == 1)


def test_plans_at_the_paper_stack_and_at_model_scale():
    """One CTA and no split at the paper's (20, 300); the card filled at
    the reference's (128, 1,000,000)."""
    plan = krum_plan(20, 300)
    assert (plan.tiles, plan.slices, plan.ctas) == (1, 1, 1) and plan.fused
    assert krum_plan(128, 1_000_000).ctas >= 132
    assert sort_plan(128, 1_000_000).ctas >= 132
    assert SORT_MAX_M == KRUM_MAX_M == 16384


def test_plans_raise_above_their_limits():
    sort_plan(SORT_MAX_M, 4)
    krum_plan(KRUM_MAX_M, 4)
    with pytest.raises(ValueError, match="m ≤ 16384"):
        sort_plan(SORT_MAX_M + 1, 4)
    with pytest.raises(ValueError, match="m ≤ 16384"):
        krum_plan(KRUM_MAX_M + 1, 4)


def test_cpu_wrappers_serve_past_the_kernels_limits(monkeypatch):
    """The plain versions serve any m: a CPU tensor never reaches a plan."""
    x = torch.from_numpy(_stack(SORT_MAX_M + 1, 2, 5, "ties"))
    np.testing.assert_array_equal(sort_workers(x).numpy().view(np.uint32),
                                  _stable_sort_bits(x.numpy()))

    def no_plan(*_):
        raise AssertionError("a CPU tensor reached a launch plan")

    monkeypatch.setattr(robust_agg, "sort_plan", no_plan)
    monkeypatch.setattr(robust_agg, "krum_plan", no_plan)
    y = torch.from_numpy(_stack(9, 30, 6, "normal"))
    sort_workers(y)
    krum_scores(y, 2)


@pytest.mark.parametrize("kind", ["normal", "integer"])
def test_krum_plain_in_blocks_keeps_its_math(monkeypatch, kind):
    """The plain krum's distances made in small blocks equal the unblocked
    (m, m, d) sum: exactly on integers, and within rtol 1e-6 otherwise (the
    same sums, reduced over tensors of another shape)."""
    x = torch.from_numpy(_stack(13, 70, 8, kind))
    whole = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    monkeypatch.setattr(robust_agg, "KRUM_PLAIN_BLOCK", 3 * 70)
    blocked = robust_agg._krum_d2_plain(x)
    if kind == "integer":
        assert torch.equal(blocked, whole)
    else:
        np.testing.assert_allclose(blocked.numpy(), whole.numpy(), rtol=1e-6)
    np.testing.assert_allclose(
        krum_scores_plain(x, 2).numpy(),
        krum_scores_ref(x.numpy(), 2), rtol=2e-5)
