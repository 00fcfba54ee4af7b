"""The port's top-k payload beyond the single-tile bound (d > 1408, the
sharded path; plain PyTorch on the CPU) against the reference's Pallas
``topk_compress_sharded`` (interpret mode off-TPU) and its oracle
``topk_compress_ref``: the same indices, index-ascending, ties at the
threshold filled lowest index first across the whole row; the oracle's
values bit for bit, the kernel's by value.  The d and k are those of the
reference's sweep (``tests/test_kernels.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import topk_compress_ref
from repro.kernels.topk_compress import (
    topk_compress_sharded as jax_topk_compress_sharded,
)
from repro_torch.compression import AdaptiveTopK, make_compressor
from repro_torch.kernels import (
    LAUNCHES,
    SINGLE_TILE_MAX_D,
    kernel_plan,
    topk_compress,
    topk_compress_plain,
    topk_compress_sharded,
)

torch.set_num_threads(1)

_B = 512  # the reference's sharded block width


def _rows(kind, m, d, seed):
    rng = np.random.default_rng(seed)
    if kind == "randn":
        x = rng.standard_normal((m, d))
    elif kind == "halves":           # quantised magnitudes: many ties
        x = np.round(rng.standard_normal((m, d)) * 2) / 2
    elif kind == "zeros":
        x = np.zeros((m, d))
    elif kind == "constant":
        x = np.ones((m, d))
    elif kind == "negative":         # values keep their sign
        x = -np.abs(rng.standard_normal((m, d))) - 0.5
    else:                            # "lone": one nonzero at a high index
        x = np.zeros((m, d))
        x[:, d - 3] = 9.0
        x[1:, d - 1] = -0.0
    return x.astype(np.float32)


def _assert_rows_match_reference(x, k):
    """Indices equal, values bit for bit the oracle's; the reference kernel's
    values equal by value (its one-hot matmul gather turns -0.0 into +0.0,
    where the oracle and the port keep the sign)."""
    v, i = topk_compress(torch.from_numpy(x), k)
    for r in range(x.shape[0]):
        jv, ji = jax_topk_compress_sharded(jnp.asarray(x[r]), k)
        rv, ri = topk_compress_ref(jnp.asarray(x[r]), k)
        np.testing.assert_array_equal(i[r].numpy(), np.asarray(ri))
        np.testing.assert_array_equal(i[r].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v[r].numpy().view(np.int32),
                                      np.asarray(rv).view(np.int32))
        np.testing.assert_array_equal(v[r].numpy(), np.asarray(jv))


@pytest.mark.parametrize("d", [1409, 4096, 4352, 5000, 65536])
@pytest.mark.parametrize("which", ["first", "tenth", "last"])
def test_sweep_matches_reference(d, which):
    k = {"first": 1, "tenth": d // 10, "last": d - 1}[which]
    _assert_rows_match_reference(_rows("randn", 2, d, d * 7 + k), k)


@pytest.mark.parametrize("d", [_B + 1 + SINGLE_TILE_MAX_D, 3000])
def test_ties_fill_lowest_index_first_across_blocks(d):
    x = _rows("halves", 2, d, d)
    for k in (1, d // 3, d - 1):
        _assert_rows_match_reference(x, k)


@pytest.mark.parametrize("kind", ["zeros", "constant", "negative", "lone"])
def test_degenerate_rows(kind):
    d = 4 * _B
    x = _rows(kind, 2, d, 0)
    for k in (3, 7, _B // 2):
        _assert_rows_match_reference(x, k)
    if kind in ("zeros", "constant"):
        v, i = topk_compress(torch.from_numpy(x), 7)
        assert torch.equal(i, torch.arange(7, dtype=torch.int32).expand(2, 7))


def test_plan_dispatch_and_cpu_path():
    assert kernel_plan(SINGLE_TILE_MAX_D) == "single_tile"
    assert kernel_plan(SINGLE_TILE_MAX_D + 1) == "sharded"
    x = torch.from_numpy(_rows("randn", 3, 5000, 1))
    before = dict(LAUNCHES)
    out = topk_compress(x, 500)
    for got in (topk_compress_sharded(x, 500), topk_compress_plain(x, 500)):
        assert all(torch.equal(a, b) for a, b in zip(out, got))
    assert LAUNCHES == before        # the CPU runs no kernel
    with pytest.raises(ValueError):
        topk_compress_sharded(x, 5001)
    with pytest.raises(TypeError):
        topk_compress_sharded(x.double(), 5)


def test_measured_delta_pins_k_trajectory_sharded_path():
    """The reference's k-trajectory pin over its gridded kernel
    (tests/test_api.py::test_measured_delta_pins_k_trajectory_gridded_kernel)
    at d = 4096: every δ-driven move changes the payload width, and each
    payload equals the reference's at that k."""
    d = 4096
    comp = AdaptiveTopK(d, 205, 3277, delta_target=0.6, use_kernel=True)
    x = _rows("randn", 1, d, 3)[0]
    ks = []
    for delta in (0.2, 0.3, 0.5, 0.7, 0.9, 0.9):
        comp.schedule_update(grad_norm=1.0, measured_delta=delta)
        ks.append(comp.k)
        v, i = comp.compress(torch.from_numpy(x))
        assert v.shape == (comp.k,) and i.shape == (comp.k,)
        rv, ri = topk_compress_ref(jnp.asarray(x), comp.k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    assert ks == [410, 820, 1640, 1640, 1640, 1640]
    assert comp.wire_bits(d) == 1640 * (32 + 12)
    assert comp.delta_bound(d) == pytest.approx(205 / 4096)
    kern = make_compressor("adaptive_topk_kernel:0.05:0.5", d)
    plain = make_compressor("adaptive_topk:0.05:0.5", d)
    assert isinstance(kern, AdaptiveTopK) and kern.use_kernel
    assert not plain.use_kernel
    assert (kern.k_min, kern.k_max) == (plain.k_min, plain.k_max) == (205,
                                                                      2048)
    assert kern.wire_bits(d) == plain.wire_bits(d)
