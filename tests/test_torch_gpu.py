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
    aggregate_sparse,
    aggregate_sparse_gridded,
    aggregate_sparse_plain,
    attention_bshd,
    attention_plain,
    cubic_plan,
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


def _cubic_case(m, d, device, seed):
    """A non-symmetric H per worker: a symmetric random part, shifted to be
    positive definite for even workers and left indefinite (a saddle, where
    the cubic term stops the growth) for odd ones, plus a small non-symmetric
    part; gradients of different scales and per-worker step sizes, so that
    the workers stop at different iterations."""
    gen = torch.Generator(device=device).manual_seed(seed)
    H = torch.empty(m, d, d, device=device)
    for w in range(m):      # one worker's draws at a time
        A = torch.randn(d, d, generator=gen, device=device)
        B = torch.randn(d, d, generator=gen, device=device)
        H[w] = (A + A.T) / (2 * d ** 0.5) + 0.05 * B / d ** 0.5
        if w % 2 == 0:
            H[w].diagonal().add_(2.0)
        del A, B
    g = torch.randn(m, d, generator=gen, device=device) / d ** 0.5
    g *= torch.logspace(0, -3, m, device=device)[:, None]
    lr = 0.1 + 0.15 * torch.rand(m, generator=gen, device=device)
    return g, H, lr


# the cubic kernel's tolerance: s within 1e-5 absolute and iteration counts
# within 1 of the plain version: the cluster's sums run in another order,
# and one iteration more or less at the tolerance boundary moves s by at
# most lr·tol.  Each worker's s also within 1e-4 of its norm (plus 2·lr·tol
# where the counts differ): the smallest workers' entries are about 1e-5
CUBIC_ATOL = 1e-5
CUBIC_RTOL = 1e-4


def _assert_cubic_close(s, it, ps, pit, lr, tol):
    assert bool(torch.isfinite(s).all())
    assert (s - ps).abs().max().item() <= CUBIC_ATOL
    assert (it - pit).abs().max().item() <= 1
    slack = torch.where(it == pit, 0.0, 2 * lr * tol)
    gap = torch.linalg.vector_norm(s - ps, dim=1)
    assert bool((gap <= CUBIC_RTOL * torch.linalg.vector_norm(ps, dim=1)
                 + slack).all())


@pytest.mark.parametrize("m,d", [(20, 1), (20, 123), (20, 300), (20, 301),
                                 (20, 5000), (6, 9000)])
def test_cubic_kernel_matches_plain(cuda, m, d):
    """Resident H (d up to 301), streamed H (5000, and 9000, past the 8192
    floats a CTA once held), and d not a multiple of 4; one launch a call."""
    g, H, lr = _cubic_case(m, d, cuda, seed=d)
    s0 = torch.zeros_like(g)
    before = LAUNCHES["cubic_solve"]
    s, it = cubic_solve(g, H, s0, lr, tol=1e-6, max_iters=300)
    assert LAUNCHES["cubic_solve"] == before + 1
    ps, pit = cubic_solve_plain(g, H, s0, lr, M=10.0, gamma=1.0, tol=1e-6,
                                max_iters=300)
    _assert_cubic_close(s, it, ps, pit, lr, 1e-6)
    assert len(set(pit.tolist())) > 1          # the workers stop apart
    plan = cubic_plan(m, d)
    assert plan.mode == ("resident" if d <= 301 else "streamed")
    if d >= 5000:
        assert plan.cluster > 1
    # the same bits on a second run: no atomics, a fixed order of sums
    s2, it2 = cubic_solve(g, H, s0, lr, tol=1e-6, max_iters=300)
    assert torch.equal(s2, s) and torch.equal(it2, it)


@pytest.mark.parametrize("m,d,mode", [
    (20, 123, "resident"), (8, 1001, "streamed"), (8, 4352, "streamed"),
    (1, 28545, "streamed_global_s")])
def test_cubic_kernel_plans_match_plain(cuda, m, d, mode):
    """Each mode where the rules pick it (the iterate in device memory past
    d = 28544: 3.26 GB of H), scalar loads (d % 4 != 0) and 16-byte ones,
    from a non-zero iterate (of norm about 0.5 at every d: a larger one
    makes the step diverge in any summation order), and one step from the
    plain answer."""
    g, H, lr = _cubic_case(m, d, cuda, seed=7 * d + m)
    gen = torch.Generator(device=cuda).manual_seed(d)
    s0 = 0.5 * torch.randn(m, d, generator=gen, device=cuda) / d ** 0.5
    assert cubic_plan(m, d).mode == mode
    s, it = cubic_solve(g, H, s0, lr, tol=1e-6, max_iters=100)
    ps, pit = cubic_solve_plain(g, H, s0, lr, M=10.0, gamma=1.0, tol=1e-6,
                                max_iters=100)
    _assert_cubic_close(s, it, ps, pit, lr, 1e-6)
    one, _ = cubic_solve(g, H, ps, lr, tol=-1.0, max_iters=1)
    p1, _ = cubic_solve_plain(g, H, ps, lr, M=10.0, gamma=1.0, tol=-1.0,
                              max_iters=1)
    assert (one - p1).abs().max().item() <= 1e-6


def test_cubic_kernel_raises_on_what_it_cannot_serve(cuda):
    with pytest.raises(RuntimeError):
        cubic_plan(0, 300)                        # no workers to lay out
    with pytest.raises(ValueError):
        cubic_plan(20, 300, device="cpu")         # a plan is for a card
    g = torch.zeros(2, 3, device=cuda)
    with pytest.raises(TypeError):                # the kernel reads float32
        cubic_solve(g, torch.zeros(2, 3, 3, device=cuda, dtype=torch.float64))


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
                                       (20, 30, 300, False),
                                       (16, 100, 4096, True),
                                       (7, 37, 1000, True),
                                       (8, 64, 8192, True),
                                       (3, 16, 65537, False),
                                       (64, 4096, 65536, False)])
def test_sparse_agg_kernel_equals_plain(cuda, m, k, d, dup):
    """Bit for bit, without weights, with 0/1 weights and with fractional
    ones: drive A's (20, 500) over 5000, w8a's (20, 30) over 300, d ≤ 4096
    with duplicates within rows and across workers, k not a power of 2,
    unsorted rows, and (64, 4096) payloads (2 MB, more than a CTA's shared
    memory); one launch a call, through ``aggregate_sparse`` at every d."""
    gen = torch.Generator(device=cuda).manual_seed(m * k + d)
    vals = torch.randn(m, k, generator=gen, device=cuda)
    if dup:
        idx = torch.randint(0, min(d, 50), (m, k), generator=gen,
                            device=cuda)
    else:
        idx = torch.argsort(torch.rand(m, d, generator=gen, device=cuda),
                            dim=1)[:, :k]
    idx = idx.to(torch.int32)
    before = LAUNCHES["sparse_agg"]
    for w in (None, (torch.rand(m, generator=gen, device=cuda) < 0.5).float(),
              2 * torch.rand(m, generator=gen, device=cuda)):
        out = aggregate_sparse(vals, idx, d, w)
        want = aggregate_sparse_plain(vals, idx, d, w)
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))
        again = aggregate_sparse_gridded(vals, idx, d, w)
        assert torch.equal(again.view(torch.int32), out.view(torch.int32))
    assert LAUNCHES["sparse_agg"] == before + 6


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
                                          (1, 4000, 32, 16, 128),
                                          (2, 300, 4, 1, 256),
                                          (1, 4096, 16, 1, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, B, S, H, Hkv, Dh, dtype):
    """Causal, sliding windows (16 and the models' 1024 and 2048) and no
    mask, with grouped kv heads and one kv head (recurrentgemma-9b's
    Dh = 256), at S a multiple of the kernels' tiles and not."""
    gen = torch.Generator(device=cuda).manual_seed(S * H + Dh)
    q, k, v = (torch.randn(B, S, h, Dh, generator=gen, device=cuda).to(dtype)
               for h in (H, Hkv, Hkv))
    before = LAUNCHES["flash_attention"]
    cases = ((True, 0), (True, 16), (True, 1024), (True, 2048), (False, 0))
    for causal, window in cases:
        got = attention_bshd(q, k, v, causal=causal, window=window)
        want = attention_plain(q, k, v, causal=causal, window=window)
        assert bool(torch.isfinite(got.float()).all())
        _close(got, want)
    assert LAUNCHES["flash_attention"] == before + len(cases)


@pytest.mark.parametrize("q_scale", [0.01, 8.0])
def test_flash_attention_bf16_holds_flat_and_peaked_softmax(cuda, q_scale):
    """The bf16 kernel feeds P to the tensor cores as two bf16 halves: a
    flat softmax (outputs near zero, the mean of up to 4096 v rows) and a
    peaked one still meet the bf16 tolerance, global and local."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    q, k, v = (torch.randn(1, 4096, h, 128, generator=gen, device=cuda)
               for h in (32, 16, 16))
    q, k, v = (q * q_scale).bfloat16(), k.bfloat16(), v.bfloat16()
    before = LAUNCHES["flash_attention"]
    for window in (0, 1024):
        _close(attention_bshd(q, k, v, window=window),
               attention_plain(q, k, v, window=window))
    assert LAUNCHES["flash_attention"] == before + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_raises_on_other_head_widths(cuda, dtype):
    """Dh outside (64, 128, 256) raises, naming the open item; nothing
    falls back to the plain version and nothing launches."""
    q = torch.zeros(1, 64, 4, 96, device=cuda, dtype=dtype)
    before = LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="Queue 2 item K2"):
        attention_bshd(q, q, q)
    assert LAUNCHES["flash_attention"] == before
