"""The port's sparse center above d = 4096 (plain PyTorch on the CPU, the
gridded path) against the reference: bit for bit its oracle
``sparse_aggregate_ref`` (weights folded in first, each coordinate summed in
stream order); its Pallas ``aggregate_sparse_gridded`` (interpret mode)
exactly on integer payloads, and within rtol 1e-5, atol 1e-6 on the float
payloads of its own tests, since that kernel combines duplicates by
differences of prefix sums."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import sparse_aggregate_ref
from repro.kernels.robust_agg import (
    aggregate_sparse_gridded as jax_aggregate_sparse_gridded,
)
from repro_torch.kernels import (
    LAUNCHES,
    SPARSE_SCATTER_MAX_D,
    agg_kernel_plan,
    aggregate_sparse,
    aggregate_sparse_gridded,
    aggregate_sparse_plain,
)

torch.set_num_threads(1)


def _payload(m, k, d, seed, *, ints=True, duplicates=False, sort=True):
    """(vals, idx): integer-valued or normal float32 values; k distinct
    coordinates a row (index-sorted, as top-k sends them, or shuffled), or
    k draws with repeats from the first min(d, 50) coordinates."""
    r = np.random.default_rng(seed)
    vals = (r.integers(-8, 9, (m, k)) if ints
            else r.standard_normal((m, k))).astype(np.float32)
    if duplicates:
        idx = r.integers(0, min(d, 50), (m, k))
    else:
        idx = np.stack([r.choice(d, k, replace=False) for _ in range(m)])
        if sort:
            idx = np.sort(idx, axis=1)
    return vals, idx.astype(np.int32)


def _port(vals, idx, d, weights=None):
    w = None if weights is None else torch.from_numpy(weights)
    return aggregate_sparse(torch.from_numpy(vals), torch.from_numpy(idx), d,
                            weights=w).numpy()


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


# the reference sweep's gridded shapes (tests/test_kernels.py) and the
# slices' widths: d = 4352 (the CPU runs) and d = 5000 (gisette's)
SHAPES = [(8, 64, 8192), (3, 16, 65537), (4, 32, 65536), (4, 435, 4352),
          (20, 500, 5000)]


@pytest.mark.parametrize("m,k,d", SHAPES)
@pytest.mark.parametrize("weighted", [False, True])
def test_integer_payloads_equal_oracle_and_reference_kernel(m, k, d,
                                                            weighted):
    vals, idx = _payload(m, k, d, seed=m * 10007 + k * 101 + d)
    w = (np.random.default_rng(d).integers(0, 2, m).astype(np.float32)
         if weighted else None)
    ref = np.asarray(sparse_aggregate_ref(vals, idx, d, w))
    out = _port(vals, idx, d, w)
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    jw = None if w is None else jnp.asarray(w)
    jout = jax_aggregate_sparse_gridded(jnp.asarray(vals), jnp.asarray(idx),
                                        d, jw)
    np.testing.assert_array_equal(out, np.asarray(jout))


def _weight_sets(m, seed):
    """No weights, 0/1 keep weights (the norm_trim center's) and fractional
    ones."""
    rng = np.random.default_rng(seed)
    return (None, rng.integers(0, 2, m).astype(np.float32),
            rng.uniform(0.0, 2.0, m).astype(np.float32))


@pytest.mark.parametrize("m,k,d", SHAPES)
def test_float_payloads_equal_oracle_bitwise(m, k, d):
    vals, idx = _payload(m, k, d, seed=d + m, ints=False)
    for w in _weight_sets(m, k):
        ref = np.asarray(sparse_aggregate_ref(vals, idx, d, w))
        np.testing.assert_array_equal(_bits(_port(vals, idx, d, w)),
                                      _bits(ref))


# the float shapes of the reference's own kernel tests (5 x 64 payloads)
# and the sweep's sparse ones.  On denser streams the reference kernel's
# prefix-sum differences drift from its own oracle (1.1e-5 at 20 x 500 over
# d = 5000), and the port is held to the oracle above
@pytest.mark.parametrize("m,k,d", [(5, 64, 8192), (5, 64, 20000),
                                   (8, 64, 8192), (3, 16, 65537),
                                   (4, 32, 65536)])
def test_float_payloads_match_reference_kernel(m, k, d):
    vals, idx = _payload(m, k, d, seed=d + m, ints=False)
    for w in _weight_sets(m, k):
        jw = None if w is None else jnp.asarray(w)
        jout = jax_aggregate_sparse_gridded(jnp.asarray(vals),
                                            jnp.asarray(idx), d, jw)
        np.testing.assert_allclose(_port(vals, idx, d, w), np.asarray(jout),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d", [8192, 9000])
@pytest.mark.parametrize("ints", [True, False])
def test_duplicates_and_unsorted_rows_follow_stream_order(d, ints):
    """Repeated coordinates within and across rows, rows not sorted by
    index: every coordinate sums in worker order, then row order."""
    for vals, idx in (_payload(6, 40, d, seed=d, ints=ints, duplicates=True),
                      _payload(5, 64, d, seed=d + 1, ints=ints, sort=False)):
        w = np.asarray([1, 0, 2, 1, 0.5, 3][:vals.shape[0]], np.float32)
        for weights in (None, w):
            ref = np.asarray(sparse_aggregate_ref(vals, idx, d, weights))
            np.testing.assert_array_equal(
                _bits(_port(vals, idx, d, weights)), _bits(ref))


@pytest.mark.parametrize("d", [4097, 9000])
def test_zero_payloads_and_zero_weights(d):
    vals = np.zeros((5, 12), np.float32)
    vals[1, 3] = -0.0
    idx = np.tile(np.arange(12, dtype=np.int32), (5, 1))
    np.testing.assert_array_equal(_bits(_port(vals, idx, d)),
                                  _bits(np.zeros(d, np.float32)))
    # a worker of weight 0 leaves exactly the oracle's 0 (and -0 * 0 adds
    # to +0), whatever its values
    vals2, idx2 = _payload(5, 12, d, seed=3, ints=False)
    w = np.asarray([0, 1, 0, 0, 1], np.float32)
    ref = np.asarray(sparse_aggregate_ref(vals2, idx2, d, w))
    np.testing.assert_array_equal(_bits(_port(vals2, idx2, d, w)), _bits(ref))


def test_plan_and_dispatch():
    assert agg_kernel_plan(8, SPARSE_SCATTER_MAX_D, k=64) == "scatter"
    assert agg_kernel_plan(8, SPARSE_SCATTER_MAX_D + 1, k=64) \
        == "sparse_gridded"
    with pytest.raises(ValueError):
        agg_kernel_plan(0, 5000, k=4)
    vals, idx = _payload(4, 32, 5000, seed=0, ints=False)
    tv, ti = torch.from_numpy(vals), torch.from_numpy(idx)
    before = dict(LAUNCHES)
    out = aggregate_sparse(tv, ti, 5000)
    assert torch.equal(out, aggregate_sparse_gridded(tv, ti, 5000))
    assert torch.equal(out, aggregate_sparse_plain(tv, ti, 5000))
    assert LAUNCHES == before        # the CPU runs no kernel
    with pytest.raises(TypeError):
        aggregate_sparse_gridded(tv.double(), ti, 5000)
    with pytest.raises(ValueError):
        aggregate_sparse_gridded(tv, ti[:, :3].contiguous(), 5000)
    with pytest.raises(ValueError):
        aggregate_sparse_gridded(tv, ti, 5000, weights=torch.ones(3))


@pytest.mark.parametrize("d", [1, 300, 4096])
@pytest.mark.parametrize("ints", [True, False])
def test_scatter_width_equals_plain_bitwise_with_duplicates(d, ints):
    """Up to d = 4096 the CPU keeps the reference's scatter-add
    (``index_add_``), and the card launches the kernel; both must give the
    contract's bits.  Heavy duplicates within rows and across workers
    (indices drawn from at most 7 coordinates), rows in no order, k not a
    power of 2, no weights, 0/1 weights and fractional ones."""
    for m, k in ((20, 30), (6, 47), (3, 200)):
        assert agg_kernel_plan(m, d, k=k) == "scatter"
        r = np.random.default_rng(d * 1000 + m * 10 + ints)
        vals = (r.integers(-8, 9, (m, k)) if ints
                else r.standard_normal((m, k))).astype(np.float32)
        idx = r.integers(0, min(d, 7), (m, k)).astype(np.int32)
        for w in _weight_sets(m, d + k):
            tw = None if w is None else torch.from_numpy(w)
            want = aggregate_sparse_plain(torch.from_numpy(vals),
                                          torch.from_numpy(idx), d, tw)
            out = _port(vals, idx, d, w)
            np.testing.assert_array_equal(_bits(out), _bits(want.numpy()))
            ref = np.asarray(sparse_aggregate_ref(vals, idx, d, w))
            np.testing.assert_array_equal(_bits(out), _bits(ref))
