"""The port's CUDA kernels against their plain versions on a card.

Marked ``gpu``: each test skips when no CUDA device is present (decided
inside the fixture, never at import).  On a card (``--noconftest``: the
suite's conftest imports jax, which the port does not need):
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py``."""
import math

import pytest
import torch

from repro_torch.kernels import (
    LAUNCHES,
    aggregate_sparse_gridded,
    aggregate_sparse_plain,
    attention_bshd,
    attention_plain,
    cubic_solve,
    cubic_solve_plain,
    krum_scores,
    krum_scores_plain,
    rmsnorm,
    rmsnorm_plain,
    sort_workers,
    sort_workers_plain,
    topk_compress,
    topk_compress_plain,
    topk_compress_sharded,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("d,k", [(1, 1), (40, 4), (300, 30), (1408, 140)])
def test_topk_kernel_equals_plain(cuda, d, k):
    gen = torch.Generator(device=cuda).manual_seed(d)
    before = LAUNCHES["topk_compress"]
    for x in (torch.randn(20, d, generator=gen, device=cuda),
              torch.randint(-3, 4, (20, d), generator=gen,
                            device=cuda).float(),
              torch.zeros(20, d, device=cuda)):
        v, i = topk_compress(x, k)
        pv, pi = topk_compress_plain(x, k)
        assert torch.equal(v, pv) and torch.equal(i, pi)
    assert LAUNCHES["topk_compress"] == before + 3


def test_cubic_kernel_matches_plain(cuda):
    m, d = 6, 123
    gen = torch.Generator(device=cuda).manual_seed(0)
    A = torch.randn(m, d, d, generator=gen, device=cuda)
    H = (A + A.transpose(1, 2)) / (2 * d ** 0.5)
    g = torch.randn(m, d, generator=gen, device=cuda)
    lr = torch.full((m,), 0.02, device=cuda)
    s0 = torch.zeros_like(g)
    s, it = cubic_solve(g, H, s0, lr, tol=1e-6, max_iters=300)
    ps, pit = cubic_solve_plain(g, H, s0, lr, M=10.0, gamma=1.0, tol=1e-6,
                                max_iters=300)
    assert (s - ps).abs().max().item() <= 1e-5
    assert (it - pit).abs().max().item() <= 1


@pytest.mark.parametrize("m,d", [(3, 1), (20, 300), (33, 513), (300, 300)])
def test_sort_workers_kernel_equals_plain_bitwise(cuda, m, d):
    """Bit for bit, ±0 in worker order and NaN last, on the card and
    against the CPU's stable sort."""
    gen = torch.Generator(device=cuda).manual_seed(m + d)
    ties = torch.randint(-2, 3, (m, d), generator=gen, device=cuda).float()
    ties = torch.where(torch.rand(m, d, generator=gen, device=cuda) < 0.5,
                       -ties, ties)
    special = ties.clone()
    special[torch.rand(m, d, generator=gen, device=cuda) < 0.1] = math.inf
    special[:, d // 2] = math.nan
    before = LAUNCHES["sort_workers"]
    for x in (torch.randn(m, d, generator=gen, device=cuda), ties, special):
        out = sort_workers(x)
        assert torch.equal(out.view(torch.int32),
                           sort_workers_plain(x).view(torch.int32))
        assert torch.equal(out.cpu().view(torch.int32),
                           sort_workers_plain(x.cpu()).view(torch.int32))
    assert LAUNCHES["sort_workers"] == before + 3


@pytest.mark.parametrize("m,d", [(3, 1), (20, 300), (33, 513), (256, 4096)])
def test_krum_kernel_matches_plain(cuda, m, d):
    """Scores within rtol 1e-5 (distances summed in another order); exact
    on an integer stack, whose sums are exact in float32."""
    gen = torch.Generator(device=cuda).manual_seed(m * d)
    x = torch.randn(m, d, generator=gen, device=cuda)
    before = LAUNCHES["krum_scores"]
    got, want = krum_scores(x, m // 5), krum_scores_plain(x, m // 5)
    assert ((got - want).abs() <= 1e-5 * want.abs()).all()
    ints = torch.randint(-3, 4, (m, min(d, 300)), generator=gen,
                         device=cuda).float()
    assert torch.equal(krum_scores(ints, m // 5),
                       krum_scores_plain(ints, m // 5))
    assert LAUNCHES["krum_scores"] == before + 2


@pytest.mark.parametrize("m,d,k", [(20, 1409, 140), (20, 5000, 500),
                                   (20, 5000, 4999), (2, 65536, 6553),
                                   (3, 65537, 1)])
def test_topk_sharded_kernel_equals_plain(cuda, m, d, k):
    """Bit for bit (values and indices) on normal rows, rows rounded to
    halves (many ties, ±0 among them) and zeros."""
    gen = torch.Generator(device=cuda).manual_seed(d + k)
    before = LAUNCHES["topk_sharded"]
    normal = torch.randn(m, d, generator=gen, device=cuda)
    for x in (normal, torch.round(normal * 2) / 2,
              torch.zeros(m, d, device=cuda)):
        v, i = topk_compress_sharded(x, k)
        pv, pi = topk_compress_plain(x, k)
        assert torch.equal(i, pi)
        assert torch.equal(v.view(torch.int32), pv.view(torch.int32))
    assert LAUNCHES["topk_sharded"] == before + 3
    if d > 1408:          # the dispatcher takes the sharded launch
        topk_compress(normal, k)
        assert LAUNCHES["topk_sharded"] == before + 4


@pytest.mark.parametrize("m,k,d,dup", [(20, 500, 5000, False),
                                       (8, 64, 8192, True),
                                       (3, 16, 65537, False)])
def test_sparse_agg_kernel_equals_plain(cuda, m, k, d, dup):
    """Bit for bit, without weights, with 0/1 weights and with fractional
    ones; duplicate indices within rows and unsorted rows included."""
    gen = torch.Generator(device=cuda).manual_seed(m * k + d)
    vals = torch.randn(m, k, generator=gen, device=cuda)
    if dup:
        idx = torch.randint(0, 50, (m, k), generator=gen, device=cuda)
    else:
        idx = torch.argsort(torch.rand(m, d, generator=gen, device=cuda),
                            dim=1)[:, :k]
    idx = idx.to(torch.int32)
    before = LAUNCHES["sparse_agg"]
    for w in (None, (torch.rand(m, generator=gen, device=cuda) < 0.5).float(),
              2 * torch.rand(m, generator=gen, device=cuda)):
        out = aggregate_sparse_gridded(vals, idx, d, w)
        want = aggregate_sparse_plain(vals, idx, d, w)
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    assert LAUNCHES["sparse_agg"] == before + 3


# The model kernels against their plain versions: float32 within 1e-5, bf16
# within rtol 2^-7 (one to two bf16 ulps: kernel and plain version differ
# only in the order of their float32 sums before the cast) and atol 1e-5
# (values near 0, where that float32 difference is not small beside them)
F32_TOL = 1e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5


def _close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    rtol, atol = ((BF16_RTOL, BF16_ATOL) if want.dtype == torch.bfloat16
                  else (F32_TOL, F32_TOL))
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("n,d", [(1, 64), (3, 100), (4, 5376), (4096, 5376),
                                 (5, 16384)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(cuda, n, d, dtype):
    """Row counts that are no multiple of a tile, a row width with no
    16-byte loads (d = 100), the model's prefill and decode shapes, and
    norm weights of the other dtype."""
    gen = torch.Generator(device=cuda).manual_seed(n + d)
    x = (3 * torch.randn(n, d, generator=gen, device=cuda)).to(dtype)
    w = 0.1 * torch.randn(d, generator=gen, device=cuda)
    before = LAUNCHES["rmsnorm"]
    for ww in (w.to(dtype), w):
        _close(rmsnorm(x, ww), rmsnorm_plain(x, ww))
    assert LAUNCHES["rmsnorm"] == before + 2


@pytest.mark.parametrize("B,S,H,Hkv,Dh", [(2, 100, 4, 2, 64),
                                          (1, 200, 4, 4, 128),
                                          (1, 4096, 32, 16, 128),
                                          (1, 4000, 32, 16, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, B, S, H, Hkv, Dh, dtype):
    """Causal, sliding windows (16 and the model's 1024) and no mask, with
    grouped kv heads, at S a multiple of the kernel's tile and not."""
    gen = torch.Generator(device=cuda).manual_seed(S * H + Dh)
    q, k, v = (torch.randn(B, S, h, Dh, generator=gen, device=cuda).to(dtype)
               for h in (H, Hkv, Hkv))
    before = LAUNCHES["flash_attention"]
    cases = ((True, 0), (True, 16), (True, 1024), (False, 0))
    for causal, window in cases:
        got = attention_bshd(q, k, v, causal=causal, window=window)
        want = attention_plain(q, k, v, causal=causal, window=window)
        assert bool(torch.isfinite(got.float()).all())
        _close(got, want)
    assert LAUNCHES["flash_attention"] == before + len(cases)
