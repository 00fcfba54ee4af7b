"""The center's rules and the Byzantine attacks against the reference's.

Every rule is pinned on its keep mask exactly and on its aggregate with an
absolute tolerance (sums in another order differ in the last bits of small
components, so a relative tolerance alone is the wrong test)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import make_aggregator as jax_make_aggregator
from repro.api.aggregators import AGGREGATOR_SPECS as JAX_AGGREGATOR_SPECS
from repro.api import make_attack as jax_make_attack
from repro.kernels.ref import sparse_aggregate_ref
from repro_torch._device import div_exact
from repro_torch.api import (
    AGGREGATOR_SPECS,
    SpecError,
    make_aggregator,
    make_attack,
)
from repro_torch.kernels import SPARSE_SCATTER_MAX_D, aggregate_sparse

torch.set_num_threads(1)


def _updates(m, d, seed):
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.01, 3.0, (m, 1))
    return (rng.standard_normal((m, d)) * scale).astype(np.float32)


@pytest.mark.parametrize("spec", [
    "mean", "norm_trim:0.3", "norm_trim:0.45", "krum:1", "krum_kernel:2",
    "trimmed_mean:0.25", "trimmed_mean_kernel:0.1", "coordinate_median",
    "coordinate_median_kernel"])
@pytest.mark.parametrize("m", [4, 9, 20])
def test_dense_rules_match_reference(spec, m):
    u = _updates(m, 30, m)
    # a norm tie and a tie in every coordinate: index order; for krum the
    # two copies score the same, and the first one wins in both
    u[1] = u[0]
    rag, rkeep = jax_make_aggregator(spec)(jnp.asarray(u))
    oag, okeep = make_aggregator(spec)(torch.from_numpy(u))
    np.testing.assert_array_equal(okeep.numpy(), np.asarray(rkeep))
    np.testing.assert_allclose(oag.numpy(), np.asarray(rag), atol=1e-6)


@pytest.mark.parametrize("spec", ["mean", "norm_trim:0.3"])
def test_sparse_path_matches_dense_and_reference(spec):
    m, d, k = 10, 60, 9
    rng = np.random.default_rng(2)
    vals = rng.standard_normal((m, k)).astype(np.float32)
    idx = np.sort(np.stack([rng.choice(d, k, replace=False)
                            for _ in range(m)]), axis=1).astype(np.int32)
    dense = np.zeros((m, d), np.float32)
    np.put_along_axis(dense, idx.astype(np.int64), vals, axis=1)
    rag, rkeep = jax_make_aggregator(spec).sparse(jnp.asarray(vals),
                                                  jnp.asarray(idx), d)
    agg = make_aggregator(spec)
    oag, okeep = agg.sparse(torch.from_numpy(vals), torch.from_numpy(idx), d)
    dag, dkeep = agg(torch.from_numpy(dense))
    np.testing.assert_array_equal(okeep.numpy(), np.asarray(rkeep))
    np.testing.assert_array_equal(okeep.numpy(), dkeep.numpy())
    np.testing.assert_allclose(oag.numpy(), np.asarray(rag), atol=1e-6)
    np.testing.assert_allclose(oag.numpy(), dag.numpy(), atol=1e-6)


def test_aggregate_sparse_matches_reference_oracle_and_raises_above_bound():
    m, k, d = 6, 5, 16                               # duplicates across workers
    rng = np.random.default_rng(0)
    vals = rng.integers(-4, 5, (m, k)).astype(np.float32)
    idx = rng.integers(0, d, (m, k)).astype(np.int32)
    w = rng.uniform(0, 1, m).astype(np.float32)
    ref = sparse_aggregate_ref(vals, idx, d, weights=np.round(w))
    out = aggregate_sparse(torch.from_numpy(vals), torch.from_numpy(idx), d,
                           weights=torch.from_numpy(np.round(w)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # above the bound the gridded path (it raised before that path was
    # ported) gives the oracle's bits too
    d = SPARSE_SCATTER_MAX_D + 1
    idx = rng.integers(0, d, (m, k)).astype(np.int32)
    ref = sparse_aggregate_ref(vals, idx, d, weights=np.round(w))
    out = aggregate_sparse(torch.from_numpy(vals), torch.from_numpy(idx), d,
                           weights=torch.from_numpy(np.round(w)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n", [1, 13, 127, 300, 400])
def test_division_by_a_count_is_the_quotient(n):
    """``div_exact`` (the center's division by the number of rows it
    averages) gives numpy's correctly rounded float32 quotient bit for bit,
    and the sparse norm_trim aggregate is its kept sum divided so."""
    x = _updates(1, 10_000, n)[0]
    got = div_exact(torch.from_numpy(x), n).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  (x / np.float32(n)).view(np.int32))
    vals = _updates(8, 5, n)
    idx = np.tile(np.arange(5, dtype=np.int32), (8, 1))
    agg, keep = make_aggregator("norm_trim:0.3").sparse(
        torch.from_numpy(vals), torch.from_numpy(idx), 5)
    kept = aggregate_sparse(torch.from_numpy(vals), torch.from_numpy(idx), 5,
                            keep).numpy()
    np.testing.assert_array_equal(
        agg.numpy().view(np.int32),
        (kept / np.float32(keep.sum())).view(np.int32))


def test_registry_grammar_and_later_slices():
    """Every head of the reference's grammar resolves to the same spec and
    checks resilience with the reference's conditions and messages."""
    assert AGGREGATOR_SPECS == JAX_AGGREGATOR_SPECS
    assert make_aggregator("norm_trim:0.25").check_resilience(0.2, 20) is None
    assert "β > α" in make_aggregator("norm_trim:0.2").check_resilience(0.2, 20)
    for spec in ("norm_trim:1.5", "nonsense", "krum:-1", "krum:x",
                 "trimmed_mean:0.5", "trimmed_mean:0", "krum_kernel:1.5"):
        with pytest.raises(SpecError):
            make_aggregator(spec)
    for spec in ("mean", "norm_trim:0.25", "krum", "krum:4", "krum_kernel",
                 "krum_kernel:4", "trimmed_mean", "trimmed_mean:0.25",
                 "trimmed_mean_kernel:0.25", "coordinate_median",
                 "coordinate_median_kernel"):
        ref, out = jax_make_aggregator(spec), make_aggregator(spec)
        assert (out.spec, out.name) == (ref.spec, ref.name)
        assert out.supports_sparse == ref.supports_sparse
        for alpha, m in ((0.2, 20), (0.25, 8), (0.3, 10), (0.45, 9)):
            assert out.check_resilience(alpha, m) == \
                ref.check_resilience(alpha, m), (spec, alpha, m)


@pytest.mark.parametrize("spec", ["negative:0.9", "flipped_label"])
def test_deterministic_attacks_match_reference(spec):
    m = 10
    rng = np.random.default_rng(1)
    s = rng.standard_normal((m, 12)).astype(np.float32)
    y = rng.integers(0, 2, (m, 7)).astype(np.float32)
    ref, out = jax_make_attack(spec, 0.3), make_attack(spec, 0.3)
    assert out.kind == ref.kind and out.spec == ref.spec
    np.testing.assert_array_equal(out.mask(m, "cpu").numpy(), np.asarray(ref.mask(m)))
    if ref.kind == "update":
        r = ref.update_hook(m)(None, jnp.asarray(s))
        o = out.update_hook(m)(None, torch.from_numpy(s))
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    else:
        r = ref.corrupt_labels(None, jnp.asarray(y))
        o = out.corrupt_labels(None, torch.from_numpy(y))
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("spec", ["gaussian:10.0", "saddle:5.0",
                                  "random_label"])
def test_random_attacks_touch_only_byzantine_rows_and_follow_the_seed(spec):
    """The reference's threefry draws cannot be replayed: the port's are
    checked by property — only the ⌊αm⌋ Byzantine rows change, the draw is
    a function of the generator's seed, and its scale is the rule's."""
    m, d = 10, 400
    atk = make_attack(spec, 0.3)
    x = torch.from_numpy(
        np.random.default_rng(0).integers(0, 2, (m, d)).astype(np.float32))

    def apply(seed):
        gen = torch.Generator().manual_seed(seed)
        if atk.kind == "update":
            return atk.update_hook(m)(gen, x)
        return atk.corrupt_labels(gen, x)

    a, b, c = apply(0), apply(0), apply(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a[3:], x[3:]) and not torch.equal(a[:3], x[:3])
    if spec.startswith("gaussian"):
        assert abs(float((a[:3] - x[:3]).std()) - 10.0) < 1.0
    elif spec.startswith("saddle"):
        assert torch.allclose(torch.linalg.vector_norm(a[:3], dim=1),
                              torch.full((3,), 5.0))
        assert torch.equal(a[0], a[2])
    else:
        assert set(a[:3].unique().tolist()) <= {0.0, 1.0}
