"""The port's top-k payload (plain PyTorch, CPU) must equal the reference's
Pallas kernel (interpret mode off-TPU) and its oracle exactly: same values,
same indices, index-ascending, ties at the threshold filled lowest index
first."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import topk_compress_ref
from repro.kernels.topk_compress import topk_compress_tiled
from repro_torch.compression import TopK
from repro_torch.kernels import (
    LAUNCHES,
    SINGLE_TILE_MAX_D,
    topk_compress,
    topk_compress_plain,
)

torch.set_num_threads(1)


def _vector(kind, d, seed):
    rng = np.random.default_rng(seed)
    if kind == "randn":
        x = rng.standard_normal(d)
    elif kind == "duplicates":       # few magnitudes, both signs: many ties
        x = rng.integers(-3, 4, d).astype(np.float64)
    elif kind == "zeros":
        x = np.zeros(d)
    else:                            # negative-heavy, with ties at -1
        x = -np.abs(rng.standard_normal(d)).round()
        x[::7] = 0.5
    return x.astype(np.float32)


def _ks(d):
    return sorted({k for k in (1, d // 10, d - 1) if k >= 1})


CASES = [(d, k, kind) for d in (1, 40, 128, 300, 1408) for k in _ks(d)
         for kind in ("randn", "duplicates", "zeros", "negative")]


@pytest.mark.parametrize("d,k", sorted({(d, k) for d, k, _ in CASES}))
def test_topk_plain_equals_reference_kernel_exactly(d, k):
    for seed, kind in enumerate(("randn", "duplicates", "zeros", "negative")):
        x = _vector(kind, d, seed + d)
        rv, ri = topk_compress_tiled(jnp.asarray(x), k)
        ov, oi = topk_compress_ref(jnp.asarray(x), k)
        pv, pi = topk_compress(torch.from_numpy(x), k)
        assert pi.dtype == torch.int32
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ri), err_msg=kind)
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv), err_msg=kind)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(oi), err_msg=kind)
        np.testing.assert_array_equal(pv.numpy(), np.asarray(ov), err_msg=kind)


def test_topk_rows_are_independent():
    """A stack of sender rows gives each row its own payload."""
    X = np.stack([_vector(kind, 300, i) for i, kind in
                  enumerate(("randn", "duplicates", "zeros", "negative"))])
    vals, idx = topk_compress(torch.from_numpy(X), 30)
    for i in range(X.shape[0]):
        rv, ri = topk_compress_ref(jnp.asarray(X[i]), 30)
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(ri))
        np.testing.assert_array_equal(vals[i].numpy(), np.asarray(rv))


def test_topk_compressor_paths_agree_and_roundtrip():
    x = torch.from_numpy(np.stack([_vector("duplicates", 40, s)
                                   for s in range(5)]))
    kern, plain = TopK(4, use_kernel=True), TopK(4)
    for a, b in zip(kern.compress(x), plain.compress(x)):
        assert torch.equal(a, b)
    r = kern.roundtrip(x)
    vals, idx = kern.compress(x)
    assert torch.equal(torch.gather(r, 1, idx.long()), vals)
    assert int((r != 0).sum()) <= 5 * 4
    assert kern.wire_bits(40) == plain.wire_bits(40) == 4 * (32 + 6)


def test_cpu_tensor_takes_the_plain_version_without_a_launch():
    before = dict(LAUNCHES)
    x = torch.from_numpy(_vector("randn", 300, 0)).reshape(1, 300)
    out = topk_compress(x, 30)
    ref = topk_compress_plain(x, 30)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert LAUNCHES == before


def test_topk_dispatcher_raises_past_the_single_tile_bound():
    """Past the bound the dispatcher takes the sharded path (it raised
    before that path was ported); on the CPU that is the plain version."""
    x = torch.from_numpy(_vector("duplicates", SINGLE_TILE_MAX_D + 1, 0))
    out = topk_compress(x, 10)
    assert all(torch.equal(a, b)
               for a, b in zip(out, topk_compress_plain(x, 10)))
    with pytest.raises(ValueError):
        topk_compress(torch.zeros(10), 11)
    with pytest.raises(TypeError):
        topk_compress(torch.zeros(10, dtype=torch.float64), 1)


def _edge_row(kind, d, seed):
    """Rows that stress the contract: ±0.0 mixed with values, ±inf among
    values, subnormals only, one magnitude with mixed signs."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(d)
    signs = np.where(rng.random(d) < 0.5, -1.0, 1.0)
    if kind == "pm_zero":
        x = np.where(rng.random(d) < 0.6, 0.0, x) * signs
    elif kind == "pm_inf":
        u = rng.random(d)
        x = np.where(u < 0.05, np.inf, np.where(u < 0.1, -np.inf, x))
    elif kind == "subnormal":
        return (x.astype(np.float32) * np.float32(1e-39)).astype(np.float32)
    else:                            # "equal"
        x = signs * 0.75
    return x.astype(np.float32)


@pytest.mark.parametrize("kind", ["pm_zero", "pm_inf", "subnormal", "equal"])
@pytest.mark.parametrize("d", [1, 300, SINGLE_TILE_MAX_D,
                               SINGLE_TILE_MAX_D + 1, 5000])
def test_edge_rows_match_the_reference_oracle(kind, d):
    """The plain version, which both kernels are held against on the card,
    equals the reference's oracle bit for bit on the edge rows the card
    checks (``chip_smoke.py``'s edge stacks), at k = 1, d / 10 and d; -0.0
    keeps its sign."""
    x = _edge_row(kind, d, d)
    for k in sorted({1, max(1, d // 10), d}):
        ov, oi = topk_compress_ref(jnp.asarray(x), k)
        pv, pi = topk_compress(torch.from_numpy(x), k)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(oi))
        np.testing.assert_array_equal(pv.numpy().view(np.int32),
                                      np.asarray(ov).view(np.int32))
