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
from repro_torch.kernels._build import SMEM_PER_BLOCK
from repro_torch.kernels.robust_agg import _krum_launch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _edge_stacks(m, d, device, seed):
    """Rows that stress the top-k contract: normal, rounded to halves and
    small integers (ties), zeros, ±0.0 mixed with values, ±inf among
    values, subnormals only, and rows of one magnitude with mixed signs."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    normal = torch.randn(m, d, generator=gen, device=device)
    signs = torch.where(rand(m, d) < 0.5, -1.0, 1.0)
    pm_zero = torch.where(rand(m, d) < 0.6, 0.0, normal) * signs
    u = rand(m, d)
    pm_inf = torch.where(u < 0.05, float("inf"),
                         torch.where(u < 0.1, float("-inf"), normal))
    return {"normal": normal, "halves": torch.round(normal * 2) / 2,
            "ints": torch.randint(-3, 4, (m, d), generator=gen,
                                  device=device).float(),
            "zeros": torch.zeros(m, d, device=device), "pm_zero": pm_zero,
            "pm_inf": pm_inf, "subnormal": normal * 1e-39,
            "equal": signs * 0.75}


def _hold_topk(fn, stacks, ks, counter):
    """Each stack through ``fn`` at each k, bit for bit the plain version,
    one launch of ``counter`` a call."""
    for name, x in stacks.items():
        for k in ks:
            before = LAUNCHES[counter]
            v, i = fn(x, k)
            assert LAUNCHES[counter] == before + 1, (name, k)
            pv, pi = topk_compress_plain(x, k)
            assert torch.equal(i, pi), (name, k)
            assert torch.equal(v.view(torch.int32), pv.view(torch.int32)), (
                name, k)


@pytest.mark.parametrize("m,d", [(20, 1), (20, 40), (20, 300), (1000, 300),
                                 (3, 1408), (20, 1408)])
def test_topk_kernel_equals_plain(cuda, m, d):
    """Values (their bits) and indices, over the edge stacks, at k = 1,
    d / 10 and d; one launch a call."""
    ks = sorted({1, max(1, d // 10), d})
    _hold_topk(topk_compress, _edge_stacks(m, d, cuda, d), ks,
               "topk_compress")


def _device_events(fn):
    """The kernels, memsets and copies one call of ``fn`` runs (the trace's
    events, with their ``name`` and ``args``: grid, block, shared memory),
    from a profiler trace: the call runs in a ``record_function`` range
    after three calls outside it (a trace may miss its first calls' device
    events), each followed by a synchronise and 2 ms of sleep, and the
    device events that start after the range's start (less 1 ms of clock
    skew) are the call's."""
    import json
    import tempfile
    import time
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(4):
            if i == 3:
                with record_function("topk_one_call"):
                    fn()
            else:
                fn()
            torch.cuda.synchronize()
            time.sleep(0.002)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())["traceEvents"]
    start = next(float(e["ts"]) for e in trace
                 if e.get("name") == "topk_one_call"
                 and e.get("cat") == "user_annotation")
    return [e for e in trace if e.get("ph") == "X"
            and e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")
            and float(e["ts"]) + 1000 >= start]


@pytest.mark.parametrize("m,d,k,name", [(20, 300, 30, "topk_warp_kernel"),
                                        (20, 5000, 500,
                                         "topk_cluster_kernel")])
def test_topk_call_is_one_kernel(cuda, m, d, k, name):
    """At the w8a and drive A shapes a call runs one kernel and nothing
    else (no memset, no copy), laid out as :func:`topk_plan` says: its CTAs
    and threads, and for the cluster kernel the shared memory
    :func:`sharded_layout` reads from the source."""
    from repro_torch.kernels import topk_plan
    from repro_torch.kernels.topk_compress import sharded_layout

    x = torch.randn(m, d, device=cuda)
    events = _device_events(lambda: topk_compress(x, k))
    assert len(events) == 1 and name in events[0]["name"], events
    plan, args = topk_plan(m, d), events[0]["args"]
    assert args["grid"] == [plan.ctas, 1, 1], args
    assert args["block"] == [plan.threads, 1, 1], args
    if plan.route == "sharded":
        smem = sharded_layout(d, plan.cluster)[2]
        assert args["shared memory"] == smem, args


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


@pytest.mark.parametrize("m,d", [(3, 1), (20, 300), (33, 513), (300, 300),
                                 (256, 4096), (32, 131072)])
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


@pytest.mark.parametrize("m,d", [(3, 1), (20, 300), (33, 513), (256, 4096),
                                 (32, 131072)])
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


@pytest.mark.parametrize("m,d", [(20, 300), (33, 513), (256, 4096),
                                 (32, 131072)])
def test_krum_kernel_d2_is_symmetric_and_repeats(cuda, m, d):
    """d2[i, j] and d2[j, i] bitwise equal, +1e30 on the diagonal, and the
    same bits on a second launch (partial sums added in a fixed order)."""
    gen = torch.Generator(device=cuda).manual_seed(m + d)
    x = torch.randn(m, d, generator=gen, device=cuda)
    scores, d2 = _krum_launch(x, m // 5)
    again, d2_again = _krum_launch(x, m // 5)
    bits = d2.view(torch.int32)
    assert torch.equal(bits, bits.T)
    assert torch.equal(bits, d2_again.view(torch.int32))
    assert torch.equal(scores.view(torch.int32), again.view(torch.int32))
    assert bool((d2.diagonal() >= 1e30).all())


def test_center_kernels_raise_past_their_limits(cuda):
    x = torch.zeros(16385, 1, device=cuda)
    with pytest.raises(ValueError, match="m ≤ 16384"):
        sort_workers(x)
    with pytest.raises(ValueError, match="m ≤ 16384"):
        krum_scores(x, 1)


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


@pytest.mark.parametrize("m,d", [(1, 1409), (20, 1409), (4, 4099),
                                 (20, 5000), (3, 65537), (1, 131072)])
def test_topk_sharded_kernel_edge_stacks(cuda, m, d):
    """The cluster kernel over the edge stacks at k = 1, d / 10 and d, one
    launch a call, through the dispatcher; (1, 131072) takes a cluster of
    8 CTAs (the cluster of 16 is held at (2, 1,000,000) below)."""
    ks = sorted({1, d // 10, d})
    _hold_topk(topk_compress, _edge_stacks(m, d, cuda, d), ks,
               "topk_sharded")


def test_topk_sharded_kernel_streams_past_shared_memory(cuda):
    """A row of 1,000,000: a cluster of 16 CTAs (the non-portable size),
    each keeping 49820 of its 62500 coordinates in shared memory and
    re-reading the rest from L2."""
    from repro_torch.kernels import topk_plan
    from repro_torch.kernels.topk_compress import sharded_layout

    plan = topk_plan(2, 1_000_000)
    slice_, keep, _ = sharded_layout(plan.d, plan.cluster)
    assert plan.cluster == 16 and slice_ == plan.slice > keep
    _hold_topk(topk_compress, _edge_stacks(2, 1_000_000, cuda, 9),
               (1, 100_000), "topk_sharded")


@pytest.mark.parametrize("m,d", [(20, 1409), (20, 5000), (2, 65536),
                                 (1, 16384), (1, 131072), (64, 65536),
                                 (1, 49152), (1, 1_000_000), (20, 10**8)])
def test_topk_sharded_layout_holds_the_plans_slices(cuda, m, d):
    """The source's layout at the plan's cluster (read by query, nothing
    launched): the plan's slice, within the card's per-block shared memory,
    and held whole wherever the plan takes it to be
    (``slice <= TOPK_SLICE_WHOLE``)."""
    from repro_torch.kernels import topk_plan
    from repro_torch.kernels.topk_compress import (
        TOPK_SLICE_WHOLE,
        sharded_layout,
    )

    plan = topk_plan(m, d)
    before = dict(LAUNCHES)
    slice_, keep, smem = sharded_layout(d, plan.cluster)
    assert LAUNCHES == before
    assert slice_ == plan.slice and 0 < keep <= slice_
    assert smem <= SMEM_PER_BLOCK and smem % 16 == 0 and keep % 4 == 0
    assert keep == slice_ or plan.slice > TOPK_SLICE_WHOLE


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
