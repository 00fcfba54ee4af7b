"""The top-k kernels' launch plan (:func:`repro_torch.kernels.topk_plan`),
a pure function of (m, d): the route by the reference's single-tile bound,
the cluster size by d and m, a slice that stays whole in a CTA's shared
memory within the card's per-block limit, and the plan at the shapes
``chip_smoke.py`` times (the w8a and gisette rounds and the reference's
top-k ladder).  The kernel's own layout of that shared memory is read on
the card (``tests/test_torch_gpu.py``)."""
import pytest

from repro_torch.kernels import (
    SINGLE_TILE_MAX_D,
    TopkPlan,
    kernel_plan,
    topk_plan,
)
from repro_torch.kernels import _build
from repro_torch.kernels._build import SMEM_PER_BLOCK, SMS
from repro_torch.kernels.topk_compress import (
    TOPK_CLUSTER_SIZES,
    TOPK_SLICE_ONE,
    TOPK_SLICE_TARGET,
    TOPK_SLICE_WHOLE,
    TOPK_WARPS,
    _slice,
)

# (m, d) -> (cluster, whole slice in shared memory): the timed shapes
LADDER = {
    (20, 5000): (1, True),        # drive A's round: one CTA a row
    (2, 65536): (8, True),
    (1, 16384): (4, True),
    (1, 131072): (8, True),
    (1, 1_000_000): (16, False),  # 62500 a CTA: the rest from L2
    (64, 65536): (2, True),       # one wave of 128 CTAs
    (20, 1409): (1, True),
}


@pytest.mark.parametrize("m,d", [(20, 300), (1000, 300), (1, 1), (7, 1408),
                                 (65535, 40)])
def test_single_tile_route_is_a_warp_a_row(m, d):
    plan = topk_plan(m, d)
    assert plan.route == kernel_plan(d) == "single_tile"
    assert (plan.warps, plan.threads) == (TOPK_WARPS, 32 * TOPK_WARPS)
    assert plan.ctas == -(-m // TOPK_WARPS)
    assert (plan.cluster, plan.slice) == (1, d)


@pytest.mark.parametrize("m,d", sorted(LADDER))
def test_cluster_size_at_the_timed_shapes(m, d):
    plan = topk_plan(m, d)
    assert plan.route == "sharded"
    assert (plan.cluster,
            plan.slice <= TOPK_SLICE_WHOLE) == LADDER[(m, d)]


@pytest.mark.parametrize("d", [1409, 2048, 5000, 8192, 8193, 16384, 65537,
                               131072, 800_000, 1_000_000, 10**8])
@pytest.mark.parametrize("m", [1, 2, 20, 64, 1000])
def test_cluster_plan_covers_the_row_within_shared_memory(m, d):
    plan = topk_plan(m, d)
    assert plan.cluster in TOPK_CLUSTER_SIZES
    assert plan.slice % 4 == 0 and plan.slice == _slice(d, plan.cluster)
    assert plan.cluster * plan.slice >= d > (plan.cluster - 1) * plan.slice
    assert plan.ctas == m * plan.cluster
    # a slice is whole in shared memory, or its cluster is the largest
    assert plan.slice <= TOPK_SLICE_WHOLE or plan.cluster == 16
    assert 4 * TOPK_SLICE_WHOLE < SMEM_PER_BLOCK
    if d <= TOPK_SLICE_ONE:
        assert plan.cluster == 1
    elif plan.cluster == 16:
        # 8 CTAs' slices would not stay whole in shared memory
        assert _slice(d, 8) > TOPK_SLICE_WHOLE
    elif plan.slice > TOPK_SLICE_TARGET and plan.cluster < 8:
        # halved from a larger cluster for fewer waves, the slices whole
        assert m * 2 * plan.cluster > SMS


def test_cluster_size_grows_with_d_and_shrinks_to_one_wave():
    sizes = [topk_plan(1, d).cluster for d in (2000, 8192, 9000, 20000,
                                               140000, 1_000_000)]
    assert sizes == [1, 1, 4, 8, 8, 16]
    assert topk_plan(64, 65536).cluster * 64 <= SMS
    assert topk_plan(1, 65536).cluster == 8
    # more rows than a wave holds, and slices past shared memory at 8
    assert topk_plan(20, 1_000_000).cluster == 16


def test_plan_boundary_cache_and_errors():
    assert topk_plan(3, SINGLE_TILE_MAX_D).route == "single_tile"
    assert topk_plan(3, SINGLE_TILE_MAX_D + 1).route == "sharded"
    assert topk_plan(20, 5000) is topk_plan(20, 5000)
    assert isinstance(topk_plan(0, 5000), TopkPlan)
    with pytest.raises(ValueError):
        topk_plan(-1, 300)
    with pytest.raises(ValueError):
        topk_plan(1, 0)


def test_entry_points_take_the_plan_and_no_scratch():
    """Both C entries take (x, vals, idx, m, d, k, stream), the cluster
    kernel also its cluster size; neither takes a scratch pointer, and the
    cluster kernel's layout is a query that launches nothing."""
    for name, plan_ints in (("topk_compress", 0), ("topk_sharded", 1)):
        symbol, argtypes = _build.ENTRY_POINTS[name]
        assert symbol == f"{name}_launch"
        assert argtypes == ([_build._P] * 3 + [_build._I] * (3 + plan_ints)
                            + [_build._P])
    assert _build.QUERIES["topk_sharded_plan"] == (
        "topk_sharded", [_build._I, _build._I, _build._P])
