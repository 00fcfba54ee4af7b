"""The port's other compressors against the reference's: scaled sign and
block int8 payload for payload on the same numpy stacks, random-k on its
properties and in distribution (its draws cannot be replayed), its
``decompress`` and the sparse center on the reference's own draws, and the
registry's eight heads."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import make_aggregator as jax_make_aggregator
from repro.compression import COMPRESSORS as JAX_COMPRESSORS
from repro.compression import BlockInt8 as JaxBlockInt8
from repro.compression import RandomK as JaxRandomK
from repro.compression import SignNorm as JaxSignNorm
from repro.compression import make_compressor as jax_make_compressor
from repro_torch.api import ExperimentSpec, SpecError, make_aggregator
from repro_torch.compression import (
    COMPRESSORS,
    AdaptiveTopK,
    BlockInt8,
    Identity,
    RandomK,
    SignNorm,
    TopK,
    make_compressor,
)

torch.set_num_threads(1)

WIDTHS = (1, 127, 128, 129, 300, 5000)
# the ℓ₁ scale is a float32 sum over d; XLA and PyTorch add in other orders
# (1 ulp at most on these stacks, measured on the CPU); bound it by 4
SCALE_ULPS = 4


def _stack(d: int, seed: int) -> np.ndarray:
    """Sender rows that reach the edges: heavy-tailed values, an all-zero
    row, signed zeros among a few values, equal magnitudes, a row at the
    int8 clip (amax 127, so the scale is 1 and halves are exact ties) and a
    row whose every block peaks at its own magnitude."""
    rng = np.random.default_rng(seed)
    rows = [rng.standard_normal(d) * np.exp(rng.standard_normal(d)),
            np.zeros(d)]
    signed_zeros = np.where(rng.uniform(size=d) < 0.5, -0.0, 0.0)
    few = rng.uniform(size=d) < 0.1
    rows.append(np.where(few, rng.standard_normal(d), signed_zeros))
    rows.append(1.5 * np.where(rng.uniform(size=d) < 0.5, -1.0, 1.0))
    ties = rng.integers(-127, 127, d) + 0.5
    ties[::7] = -127.0
    ties[0] = ties[-1] = 127.0
    rows.append(ties)
    rows.append(rng.uniform(-1, 1, d) * 10.0 ** rng.integers(-30, 30, d))
    return np.stack(rows).astype(np.float32)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a − b| in units of the float32 spacing at b."""
    return np.abs(a - b) / np.spacing(np.abs(b).astype(np.float32))


@pytest.mark.parametrize("d", WIDTHS)
def test_signnorm_matches_reference(d):
    x = _stack(d, d)
    ref = JaxSignNorm()
    rsigns, rscale = jax.vmap(ref.compress)(jnp.asarray(x))
    comp = SignNorm()
    signs, scale = comp.compress(torch.from_numpy(x))
    assert signs.dtype == torch.int8 and tuple(signs.shape) == x.shape
    assert tuple(scale.shape) == (x.shape[0],)
    # sign(±0) = 0 in both
    np.testing.assert_array_equal(signs.numpy(), np.asarray(rsigns))
    assert (signs.numpy()[1:3][x[1:3] == 0] == 0).all()
    assert _ulps(scale.numpy(), np.asarray(rscale)).max() <= SCALE_ULPS
    # rows whose ℓ₁ sums are exact (zeros, equal magnitudes, the int8 clip
    # row's halves) agree bit for bit
    exact = [1, 3, 4]
    np.testing.assert_array_equal(scale.numpy()[exact],
                                  np.asarray(rscale)[exact])
    # the receiver: on the reference's payload, bit for bit
    out = comp.decompress((torch.from_numpy(np.asarray(rsigns)),
                           torch.from_numpy(np.asarray(rscale))), d)
    want = jax.vmap(lambda s, c: ref.decompress((s, c), d))(rsigns, rscale)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    assert comp.wire_bits(d) == ref.wire_bits(d) == d + 32
    assert comp.delta_bound(d) == ref.delta_bound(d) == 1.0 / d
    # one sender's (d,) vector, as the downlink sends it
    s1, c1 = comp.compress(torch.from_numpy(x[0]))
    assert tuple(s1.shape) == (d,) and c1.dim() == 0
    assert tuple(comp.decompress((s1, c1), d).shape) == (d,)


@pytest.mark.parametrize("block", [128, 64])
@pytest.mark.parametrize("d", WIDTHS)
def test_block_int8_matches_reference_bit_for_bit(d, block):
    x = _stack(d, 10 * d + block)
    ref = JaxBlockInt8(block)
    rq, rscale = jax.vmap(ref.compress)(jnp.asarray(x))
    comp = BlockInt8(block)
    q, scale = comp.compress(torch.from_numpy(x))
    nb = -(-d // block)
    assert q.dtype == torch.int8 and tuple(q.shape) == (x.shape[0], nb, block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(rscale))
    # the all-zero row: scale 1 and zero codes; the clip row's codes reach
    # ±127 and its halves round to even
    assert (scale.numpy()[1] == 1.0).all() and (q.numpy()[1] == 0).all()
    codes = q.numpy()[4].reshape(-1)[:d]
    assert codes.max() == 127 and codes.min() >= -127
    if d >= 128:
        assert (codes[x[4] == 2.5] == 2).all()
        assert (codes[x[4] == -2.5] == -2).all()
    out = comp.decompress((q, scale), d)
    want = jax.vmap(lambda a, b: ref.decompress((a, b), d))(rq, rscale)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    assert comp.wire_bits(d) == ref.wire_bits(d) == 8 * d + nb * 32
    assert comp.delta_bound(d) == ref.delta_bound(d)
    assert comp.name == ref.name == f"int8({block})"
    q1, s1 = comp.compress(torch.from_numpy(x[0]))
    assert tuple(q1.shape) == (nb, block) and tuple(s1.shape) == (nb,)
    np.testing.assert_array_equal(comp.decompress((q1, s1), d).numpy(),
                                  out.numpy()[0])


def _randk_rows(m, d, seed):
    return np.random.default_rng(seed).standard_normal((m, d)).astype(
        np.float32)


@pytest.mark.parametrize("m,d,k", [(20, 300, 30), (3, 1, 1), (5, 40, 40),
                                   (4, 5000, 500)])
def test_randk_payload_properties(m, d, k):
    """k distinct indices in [0, d) per row, ascending, values = x[idx];
    the same generator state draws the same sets, another state others."""
    x = torch.from_numpy(_randk_rows(m, d, k))
    comp = RandomK(k)
    gen = torch.Generator().manual_seed(0)
    vals, idx = comp.compress(x, generator=gen)
    assert tuple(vals.shape) == tuple(idx.shape) == (m, k)
    assert ((idx >= 0) & (idx < d)).all()
    assert (idx[:, 1:] > idx[:, :-1]).all()    # sorted and distinct
    np.testing.assert_array_equal(vals.numpy(),
                                  np.take_along_axis(x.numpy(), idx.numpy(),
                                                     axis=1))
    vals_again, idx_again = comp.compress(
        x, generator=torch.Generator().manual_seed(0))
    assert torch.equal(idx_again, idx) and torch.equal(vals_again, vals)
    _, idx_next = comp.compress(x, generator=gen)
    assert k == d or not torch.equal(idx_next, idx)
    dense = comp.decompress((vals, idx), d)
    np.testing.assert_array_equal(
        dense.numpy()[np.arange(m)[:, None], idx.numpy()], vals.numpy())
    assert int((dense != 0).sum()) == int((vals != 0).sum())
    ref = JaxRandomK(k)
    assert comp.wire_bits(d) == ref.wire_bits(d) == min(k, d) * 32 + 32
    assert comp.delta_bound(d) == ref.delta_bound(d) == min(k, d) / d
    with pytest.raises(ValueError, match="Generator"):
        comp.compress(x)


def test_randk_is_uniform_in_distribution():
    """2000 draws of k = 30 from d = 300 at a fixed seed: each coordinate's
    inclusion count is Binomial(2000, 0.1), mean 200 and sd 13.4; the
    counts' chi-square over the 300 cells sits near its 299 degrees of
    freedom; the mean measured δ̂ is k/d = 0.1 (its sd over 2000 rows is
    about 0.0013)."""
    n, d, k = 2000, 300, 30
    x = torch.from_numpy(_randk_rows(n, d, 7))
    vals, idx = RandomK(k).compress(
        x, generator=torch.Generator().manual_seed(1234))
    counts = np.bincount(idx.numpy().reshape(-1), minlength=d)
    assert counts.sum() == n * k
    assert np.abs(counts - 200).max() <= 5 * 13.4
    chi2 = float(((counts - 200.0) ** 2 / 200.0).sum())
    assert 299 - 5 * np.sqrt(2 * 299) < chi2 < 299 + 5 * np.sqrt(2 * 299)
    delta = (vals.double() ** 2).sum(1) / (x.double() ** 2).sum(1)
    assert abs(float(delta.mean()) - k / d) < 0.005


def test_randk_decompress_and_sparse_center_on_reference_draws():
    """The reference draws the index sets (threefry, one key a sender, as
    its channel splits them); the port's ``decompress`` and sparse center
    over those same payloads give the reference's numbers bit for bit."""
    m, d, k = 20, 300, 30
    x = jnp.asarray(_randk_rows(m, d, 11))
    ref = JaxRandomK(k)
    keys = jax.random.split(jax.random.PRNGKey(5), m)
    rvals, ridx = jax.vmap(lambda xi, ki: ref.compress(xi, key=ki))(x, keys)
    ridx = ridx.astype(jnp.int32)
    vals = torch.from_numpy(np.asarray(rvals))
    idx = torch.from_numpy(np.asarray(ridx))
    comp = RandomK(k)
    want = jax.vmap(lambda v, i: ref.decompress((v, i), d))(rvals, ridx)
    np.testing.assert_array_equal(comp.decompress((vals, idx), d).numpy(),
                                  np.asarray(want))
    for spec in ("mean", "norm_trim:0.3"):
        rag, rkeep = jax_make_aggregator(spec).sparse(rvals, ridx, d)
        oag, okeep = make_aggregator(spec).sparse(vals, idx, d)
        np.testing.assert_array_equal(okeep.numpy(), np.asarray(rkeep))
        np.testing.assert_array_equal(oag.numpy(), np.asarray(rag))


def test_registry_resolves_the_reference_heads():
    assert COMPRESSORS == JAX_COMPRESSORS
    assert len(COMPRESSORS) == 8
    d = 300
    want = {
        "none": (Identity, None), "topk:0.1": (TopK, 30),
        "topk_kernel:0.1": (TopK, 30), "randk:0.1": (RandomK, 30),
        "randk:32": (RandomK, 32), "signnorm": (SignNorm, None),
        "int8": (BlockInt8, None), "int8:64": (BlockInt8, None),
        "adaptive_topk:0.05:0.5": (AdaptiveTopK, 15),
        "adaptive_topk_kernel": (AdaptiveTopK, 15),
    }
    for spec, (cls, k) in want.items():
        comp = make_compressor(spec, d)
        ref = jax_make_compressor(spec, d)
        assert isinstance(comp, cls), spec
        assert type(ref).__name__ == cls.__name__, spec
        assert comp.name == ref.name, spec
        assert comp.wire_bits(d) == ref.wire_bits(d), spec
        assert comp.delta_bound(d) == ref.delta_bound(d), spec
        if k is not None:
            assert comp.k == ref.k == k, spec
    assert make_compressor("int8:64", d).block == 64
    assert make_compressor("int8", d).block == 128
    assert make_compressor("randk:1.0", d).k == d


@pytest.mark.parametrize("spec", ["int8:abc", "randk:abc", "int8:0",
                                  "int8:64517", "signum"])
def test_registry_rejects_bad_arguments_as_the_reference_does(spec):
    """Bad arguments raise with the reference's message; where the reference
    asserts (a block outside [1, 64516]) the port raises a ValueError with
    the assertion's message, so the spec check turns it into a
    ``SpecError``."""
    try:
        jax_make_compressor(spec, 300)
    except (AssertionError, ValueError) as e:
        ref_msg = str(e)
    else:
        pytest.fail(f"the reference accepted {spec!r}")
    with pytest.raises(ValueError) as exc:
        make_compressor(spec, 300)
    head = ref_msg.partition(":")[0].partition(";")[0]
    assert head in str(exc.value)
    with pytest.raises(SpecError, match="compressor="):
        ExperimentSpec(problem="w8a-logistic", m_workers=20,
                       compressor=spec).validate()
