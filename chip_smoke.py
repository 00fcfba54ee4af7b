#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

From the root of a checkout, with one card.  In order it:

1. builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together);
2. prints the card's name and power limit;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes of the w8a run (top-k exactly, ties included; the cubic solve
   within an absolute 1e-5, the bound the CPU parity tests use for
   Algorithm 2: one iteration more or less at the tolerance boundary moves
   s by at most lr·tol, and the matvec sums in another order); then the
   center's kernels over (m, d) in :data:`AGG_SHAPES`: the worker sort bit
   for bit (ties, ±0, ±inf and a NaN column included; also against the
   CPU's stable sort), krum's scores within rtol 1e-5 (distances summed in
   another order) and exactly on an integer stack, and krum's argmin
   wherever the two best scores differ by more than that;
4. runs Algorithm 1 through ``ExperimentSpec.build()`` at full width: the
   paper's w8a logistic regression (d = 300, m = 20, 2487 rows per worker)
   with top-k uplinks through the kernel, EF21, norm_trim and a
   negative-update attack, for 5 rounds; then the sparse-center variant
   (no error feedback, flipped labels) for 3 rounds; then the paper's
   comparison rules through their kernel heads under a Gaussian attack
   (:data:`W8A_RULES`), 3 rounds each.  Kernel launch counts are set to 0
   just before each run and read just after; the ledger's integers, a
   decreasing loss and one launch a round of each kernel the run uses (and
   none of the others) are asserted;
5. at gisette's width (d = 5000, LIBSVM's ``gisette``: 6000 rows, here a
   synthetic twin over m = 20 workers of 300 rows, :data:`DRIVE_A`), holds
   the cubic solve against its plain version on the first round's g and H,
   the sharded top-k against its plain version bit for bit over
   :data:`SHARDED_TOPK_SHAPES` (the round's own (20, 5000) updates, normal
   and tie-heavy rows), and the gridded sparse center bit for bit over
   :data:`SPARSE_AGG_SHAPES` (the round's own (20, 500) payloads, with 0/1
   weights and without; duplicates within rows); then drives A (sparse
   center, 3 rounds) and B (adaptive top-k with EF21, 4 rounds), with the
   same checks as the w8a drives, the bits of B following its k, which
   must move;
6. runs small specs on the card and on the CPU (plain versions), over the
   same data, and holds the two against each other: for norm_trim and each
   kernel head of the comparison rules, and at d = 4352 for the sharded
   top-k and the gridded center (:data:`SMALL_LARGE_D`, keep masks too);
7. times each kernel call, its plain version and, where one PyTorch call
   computes the same function (``torch.topk``, ``torch.sort``,
   ``index_add_``), that call with CUDA events (``ms``, ``plain_ms``,
   ``library_ms``: per call, host launch overhead included), the kernels
   alone with ``torch.profiler`` (``device_ms``), and works out each
   kernel's bound from this run's inputs; then profiles one round of
   drive A and of each w8a spec.

The line before the last carries the card's name and power limit, the one
before it the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device it exits 1 before doing anything.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# The w8a main path: the spec of the port's first slice.
W8A = dict(problem="w8a-logistic", m_workers=20, runtime="paper",
           solver="cubic_newton", compressor="topk_kernel:0.1",
           ef_damping=0.75, aggregator="norm_trim:0.3", attack="negative:0.9",
           alpha=0.2, M=10.0, gamma=1.0, eta=1.0, solver_tol=1e-6,
           solver_iters=500)
W8A_SPARSE = dict(W8A, error_feedback="none", attack="flipped_label")
# exact wire integers per round (w8a, topk:0.1, m = 20), as the reference
# package computes them: 20 · 30 · (32 + 9) up, 32 · 300 down
UPLINK_BITS, DOWNLINK_BITS = 24600, 9600
# the paper's comparison rules at the Fig. 1-2 strengths for α = 0.2,
# m = 20 (n_byz = ⌊αm⌋ = 4; α + 1/m = 0.25 trimmed per side), each with
# the kernel it runs
W8A_RULES = {
    "krum_kernel:4": "krum_scores",
    "trimmed_mean_kernel:0.25": "sort_workers",
    "coordinate_median_kernel": "sort_workers",
}
SMALL = dict(problem="synthetic-logistic:1600:40", m_workers=8,
             compressor="topk_kernel:0.25", aggregator="norm_trim:0.4",
             attack="negative:0.9", alpha=0.25)
SMALL_RULES = ("norm_trim:0.4", "krum_kernel:2", "trimmed_mean_kernel:0.375",
               "coordinate_median_kernel")
# The d = 5000 path: gisette's width (LIBSVM's ``gisette``, 6000 training
# rows and 5000 features), a synthetic twin over m = 20 workers, 300 rows
# each.  A: the sparse center, through the sharded top-k and the gridded
# center; B: adaptive top-k through the sharded kernel at a moving k, EF21,
# a dense center
GISETTE = dict(problem="synthetic-logistic:6000:5000", m_workers=20,
               runtime="paper", solver="cubic_newton", M=10.0, gamma=1.0,
               eta=1.0, solver_tol=1e-6, solver_iters=500,
               aggregator="norm_trim:0.3", alpha=0.2)
DRIVE_A = dict(GISETTE, compressor="topk_kernel:0.1", error_feedback="none",
               attack="flipped_label")
DRIVE_B = dict(GISETTE, compressor="adaptive_topk_kernel:0.05:0.5",
               ef_damping=0.75, attack="negative:0.9")
GISETTE_D = 5000
# exact wire integers per round, k·(32 + index_bits(5000) = 13) per worker
# up, 32 · 5000 down: 20 · 500 · 45 for A
GISETTE_DOWNLINK_BITS = 32 * GISETTE_D


def gisette_uplink_bits(k: int) -> int:
    return 20 * k * (32 + 13)


SHARDED_TOPK_SHAPES = ((20, 1409, 140), (20, 5000, 500), (20, 5000, 4999),
                       (2, 65536, 6553), (3, 65537, 1))
# (m, k, d, duplicate indices within rows)
SPARSE_AGG_SHAPES = ((20, 500, 5000, False), (8, 64, 8192, True),
                     (3, 16, 65537, False))
# a spec past both single-tile bounds, small enough for the CPU
SMALL_LARGE_D = dict(problem="synthetic-logistic:512:4352", m_workers=4,
                     solver_iters=100, compressor="topk_kernel:0.1",
                     error_feedback="none", aggregator="norm_trim:0.4",
                     attack="flipped_label", alpha=0.25)
CUBIC_ATOL = 1e-5
# the center's kernels: the w8a stack, odd shapes, m = 256 (the reference
# kernel's on-chip bound) and m > 256
AGG_SHAPES = ((3, 1), (20, 300), (33, 513), (256, 4096), (300, 300))
KRUM_RTOL = 1e-5

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and non-tensor fp32 ops/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def check(ok, what) -> None:
    """Fail the run (whatever Python's optimisation flags) unless ``ok``."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms_by_name(fn, reps: int, names) -> dict:
    """Mean device milliseconds per call of ``fn`` of the device work whose
    name contains each of ``names`` (None where the trace shows none), and
    under ``"all"`` of every device event of the call, from a
    ``torch.profiler`` trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    totals = dict.fromkeys((*names, "all"), 0.0)
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total",
                     getattr(evt, "cuda_time_total", 0.0))
        totals["all"] += us
        for name in names:
            if name in evt.key:
                totals[name] += us
    return {name: (us / 1e3 / reps if us > 0 else None)
            for name, us in totals.items()}


def kernel_device_ms(fn, reps: int, kernel: str):
    """Mean device milliseconds of the CUDA kernel whose name contains
    ``kernel``, per call of ``fn`` (None when the trace shows none)."""
    return device_ms_by_name(fn, reps, (kernel,))[kernel]


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def first_round_solver_inputs(exp):
    """The cubic solve's inputs in a run's first round: every worker's g
    and H at w0, and the step sizes."""
    from repro_torch.kernels import default_lr

    algo, p = exp.algo, exp.problem
    cfg = algo.config
    g = algo._worker_grads(p.w0, p.X_workers, p.y_workers).contiguous()
    H = algo._worker_hessians(p.w0, p.X_workers, p.y_workers).contiguous()
    lr = default_lr(H, cfg.M, cfg.gamma).contiguous()
    return g, H, lr, cfg


def check_kernels(exp):
    """Each kernel against its plain version on the card; returns the
    record of each (without launches and times)."""
    import torch

    from repro_torch.kernels import (
        cubic_solve,
        cubic_solve_plain,
        topk_compress,
        topk_compress_plain,
    )

    g, H, lr, cfg = first_round_solver_inputs(exp)
    s0 = torch.zeros_like(g)
    kw = dict(M=cfg.M, gamma=cfg.gamma, tol=cfg.solver_tol,
              max_iters=cfg.solver_iters)
    s, iters = cubic_solve(g, H, s0, lr, **kw)
    torch.cuda.synchronize()
    ps, piters = cubic_solve_plain(g, H, s0, lr, **kw)
    check(s.shape == g.shape and bool(torch.isfinite(s).all()),
          "finite solve of the expected shape")
    cubic_err = float((s - ps).abs().max())
    log(f"cubic_solve vs plain: max |Δs| = {cubic_err:.3e} "
        f"(atol {CUBIC_ATOL}), iterations {iters.tolist()} vs "
        f"{piters.tolist()}")
    check(cubic_err <= CUBIC_ATOL, cubic_err)
    # one iteration from a non-zero iterate: cubic_step's contract
    s1, _ = cubic_solve(g, H, ps, lr, M=cfg.M, gamma=cfg.gamma, tol=-1.0,
                        max_iters=1)
    p1, _ = cubic_solve_plain(g, H, ps, lr, M=cfg.M, gamma=cfg.gamma,
                              tol=-1.0, max_iters=1)
    step_err = float((s1 - p1).abs().max())
    check(step_err <= 1e-6, step_err)

    k = exp.algo.uplink.compressor.k
    gen = torch.Generator(device=g.device).manual_seed(0)
    ties = torch.randint(-3, 4, s.shape, generator=gen,
                         device=g.device).float()
    topk_err = 0.0
    for name, x in (("w8a updates", s), ("tie-heavy", ties),
                    ("all zeros", torch.zeros_like(s))):
        for kk in (1, k, x.shape[1] - 1):
            v, i = topk_compress(x, kk)
            torch.cuda.synchronize()
            pv, pi = topk_compress_plain(x, kk)
            check(torch.equal(i, pi), (name, kk))
            check(torch.equal(v, pv), (name, kk))
            topk_err = max(topk_err, float((v - pv).abs().max()))
    log(f"topk_compress equals its plain version exactly (w8a updates, "
        f"tie-heavy, zeros; k in 1, {k}, d-1)")
    return {"g": g, "H": H, "lr": lr, "cfg": cfg, "s": s,
            "cubic_err": cubic_err, "topk_err": topk_err, "k": k}


def agg_stacks(m: int, d: int, gen):
    """The center kernels' test stacks on the card: ``normal`` (rows of
    different scales), ``ties`` (few distinct values, zeros of both signs)
    and ``special`` (``ties`` with ±inf and a column holding NaN)."""
    import torch

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device="cuda")

    normal = torch.randn(m, d, generator=gen, device="cuda") * (
        0.01 + 3 * rand(m, 1))
    ties = torch.randint(-2, 3, (m, d), generator=gen, device="cuda").float()
    ties = torch.where(rand(m, d) < 0.5, -ties, ties)  # -(0.0) is -0.0
    special = ties.clone()
    special[rand(m, d) < 0.1] = math.inf
    special[rand(m, d) < 0.1] = -math.inf
    special[:, d // 2] = torch.where(rand(m) < 0.5, math.nan, 1.0)
    return {"normal": normal, "ties": ties, "special": special}


def center_stack(inp: dict):
    """What the center receives in a w8a round under the Gaussian attack:
    the solve's (20, 300) output through top-k (k = 30) and back to dense,
    N(0, 10²) added on the ⌊αm⌋ = 4 Byzantine rows."""
    import torch

    from repro_torch.kernels import topk_compress, topk_decompress

    s, k = inp["s"], inp["k"]
    vals, idx = topk_compress(s, k)
    stack = topk_decompress(vals, idx, s.shape[1])
    gen = torch.Generator(device=s.device).manual_seed(2)
    stack[:4] += 10.0 * torch.randn(4, s.shape[1], generator=gen,
                                    device=s.device)
    return stack.contiguous()


def scores_decide(scores) -> bool:
    """Whether krum's two best scores differ by more than :data:`KRUM_RTOL`:
    only then must the kernel's argmin equal the plain version's."""
    import torch

    best = torch.sort(scores).values
    return (len(best) > 1
            and float(best[1] - best[0]) > KRUM_RTOL * abs(float(best[0])))


def check_agg_kernels(center):
    """The center's kernels against their plain versions on the card, over
    :data:`AGG_SHAPES` and the w8a round's own stack; returns their
    records' errors."""
    import torch

    from repro_torch.core import aggregation as agg
    from repro_torch.kernels import (
        coordinate_median_fused,
        krum_scores,
        krum_scores_plain,
        sort_workers,
        sort_workers_plain,
        trimmed_mean_fused,
    )

    def bits(t):
        return t.view(torch.int32)

    gen = torch.Generator(device="cuda").manual_seed(1)
    krum_rel, n_argmin = 0.0, 0
    for m, d in AGG_SHAPES:
        stacks = agg_stacks(m, d, gen)
        for kind, x in stacks.items():
            out = sort_workers(x)
            torch.cuda.synchronize()
            check(torch.equal(bits(out), bits(sort_workers_plain(x))),
                  ("sort_workers vs plain", m, d, kind))
            check(torch.equal(bits(out.cpu()),
                              bits(sort_workers_plain(x.cpu()))),
                  ("sort_workers vs the CPU's stable sort", m, d, kind))
        x, n_byz = stacks["normal"], m // 5
        got = krum_scores(x, n_byz)
        torch.cuda.synchronize()
        want = krum_scores_plain(x, n_byz)
        check(bool(((got - want).abs() <= KRUM_RTOL * want.abs()).all()),
              ("krum_scores vs plain", m, d))
        krum_rel = max(krum_rel, float(((got - want).abs()
                                        / want.abs()).max()))
        if scores_decide(want):
            check(int(torch.argmin(got)) == int(torch.argmin(want)),
                  ("krum argmin", m, d))
            n_argmin += 1
    ints = torch.randint(-3, 4, (20, 300), generator=gen,
                         device="cuda").float()
    check(torch.equal(krum_scores(ints, 4), krum_scores_plain(ints, 4)),
          "krum_scores exact on an integer stack")
    log(f"sort_workers equals its plain version bit for bit over {AGG_SHAPES}"
        f" (normal, ties with ±0, ±inf and NaN), and the CPU's stable sort; "
        f"krum_scores within rtol {KRUM_RTOL} (largest {krum_rel:.3e}), "
        f"exact on integers, argmin equal in {n_argmin} shapes")

    # the w8a round's own stack, and the epilogues on top of the sort
    got, want = krum_scores(center, 4), krum_scores_plain(center, 4)
    check(bool(((got - want).abs() <= KRUM_RTOL * want.abs()).all()),
          "krum_scores on the w8a stack")
    check(not scores_decide(want)
          or int(torch.argmin(got)) == int(torch.argmin(want)),
          "krum argmin on the w8a stack")
    krum_err = float((got - want).abs().max())
    srt = sort_workers(center)
    check(torch.equal(bits(srt), bits(sort_workers_plain(center))),
          "sort_workers on the w8a stack")
    check(torch.equal(trimmed_mean_fused(center, 0.25),
                      agg.trimmed_mean(center, 0.25)), "trimmed mean")
    check(torch.equal(coordinate_median_fused(center),
                      agg.coordinate_median(center)), "coordinate median")
    log(f"w8a center stack {tuple(center.shape)}: krum max |Δ| {krum_err:.3e},"
        f" sort, trimmed mean and median bit for bit")
    return {"krum_err": krum_err, "krum_rel": krum_rel,
            "sort_err": float((srt - sort_workers_plain(center)).abs().max())}


def check_gisette_kernels():
    """At gisette's width (:data:`DRIVE_A`'s data), the kernels against
    their plain versions on the card: the cubic solve on the first round's
    g and H (atol :data:`CUBIC_ATOL`); the sharded top-k bit for bit over
    :data:`SHARDED_TOPK_SHAPES` (the solve's (20, 5000) output, normal rows
    and rows rounded to halves, ±0 among them); the gridded center bit for
    bit over :data:`SPARSE_AGG_SHAPES` (the solve's top-k payloads, with the
    norm_trim keep as 0/1 weights and without).  Returns the inputs and
    errors for the timings."""
    import torch

    from repro_torch.api import ExperimentSpec
    from repro_torch.core.aggregation import norm_trim_keep
    from repro_torch.kernels import (
        aggregate_sparse_gridded,
        aggregate_sparse_plain,
        cubic_solve,
        cubic_solve_plain,
        topk_compress_plain,
        topk_compress_sharded,
    )

    def bits(t):
        return t.view(torch.int32)

    exp = ExperimentSpec(**DRIVE_A).build()
    exp.algo._ensure_channels(exp.problem.dim, exp.problem.m_workers)
    g, H, lr, cfg = first_round_solver_inputs(exp)
    s0 = torch.zeros_like(g)
    kw = dict(M=cfg.M, gamma=cfg.gamma, tol=cfg.solver_tol,
              max_iters=cfg.solver_iters)
    s, iters = cubic_solve(g, H, s0, lr, **kw)
    torch.cuda.synchronize()
    ps, piters = cubic_solve_plain(g, H, s0, lr, **kw)
    cubic_err = float((s - ps).abs().max())
    check(s.shape == (20, GISETTE_D) and bool(torch.isfinite(s).all()),
          "finite d = 5000 solve")
    check(cubic_err <= CUBIC_ATOL, ("cubic at d = 5000", cubic_err))
    n_iters = int(iters.sum())
    cubic_ms = cuda_ms(lambda: cubic_solve(g, H, s0, lr, **kw), reps=2,
                       warmup=1)
    cubic_plain_ms = cuda_ms(lambda: cubic_solve_plain(g, H, s0, lr, **kw),
                             reps=1, warmup=0)
    log(f"cubic_solve at d = 5000 vs plain: max |Δs| = {cubic_err:.3e}, "
        f"iterations {iters.tolist()} vs {piters.tolist()}; {cubic_ms:.3f} "
        f"ms a call, plain {cubic_plain_ms:.3f} ms")
    del g, H, lr, s0, ps
    torch.cuda.empty_cache()

    k = exp.algo.uplink.compressor.k
    check(k == 500, k)
    gen = torch.Generator(device="cuda").manual_seed(4)
    topk_err = 0.0
    for m, d, kk in SHARDED_TOPK_SHAPES:
        normal = torch.randn(m, d, generator=gen, device="cuda")
        stacks = {"normal": normal, "halves": torch.round(normal * 2) / 2}
        if (m, d) == tuple(s.shape):
            stacks["d = 5000 updates"] = s
        for kind, x in stacks.items():
            v, i = topk_compress_sharded(x, kk)
            torch.cuda.synchronize()
            pv, pi = topk_compress_plain(x, kk)
            check(torch.equal(i, pi) and torch.equal(bits(v), bits(pv)),
                  ("topk_sharded vs plain", m, d, kk, kind))
            topk_err = max(topk_err, float((v - pv).abs().max()))
    log(f"topk_compress_sharded equals its plain version bit for bit over "
        f"{SHARDED_TOPK_SHAPES} (normal, halves; the d = 5000 updates)")

    vals, idx = topk_compress_sharded(s, k)
    keep, _ = norm_trim_keep(torch.linalg.vector_norm(vals, dim=1),
                             exp.algo.aggregator.beta)
    agg_err = 0.0
    for m, kk, d, dup in SPARSE_AGG_SHAPES:
        if (m, kk, d) == (*vals.shape, GISETTE_D):
            pv, pi = vals, idx
        else:
            pv = torch.randn(m, kk, generator=gen, device="cuda")
            hi = 50 if dup else d
            pi = (torch.randint(0, hi, (m, kk), generator=gen, device="cuda")
                  if dup else torch.argsort(torch.rand(
                      m, d, generator=gen, device="cuda"), dim=1)[:, :kk])
            pi = pi.to(torch.int32)
        w01 = (keep if m == keep.shape[0] else
               (torch.rand(m, generator=gen, device="cuda") < 0.5).float())
        for w in (None, w01):
            out = aggregate_sparse_gridded(pv, pi, d, w)
            torch.cuda.synchronize()
            want = aggregate_sparse_plain(pv, pi, d, w)
            check(torch.equal(bits(out), bits(want)),
                  ("sparse_agg vs plain", m, kk, d, dup, w is None))
            agg_err = max(agg_err, float((out - want).abs().max()))
    log(f"aggregate_sparse_gridded equals its plain version bit for bit over "
        f"{SPARSE_AGG_SHAPES} (the d = 5000 payloads; 0/1 weights and none)")
    return {"s": s, "k": k, "vals": vals, "idx": idx, "keep": keep,
            "topk_err": topk_err, "agg_err": agg_err,
            "cubic": {"shape": [20, GISETTE_D], "iterations": n_iters,
                      "max_abs_err": cubic_err, "ms": cubic_ms,
                      "plain_ms": cubic_plain_ms}}


def drive(spec_kw: dict, rounds: int, *, sparse: bool,
          kernels=("cubic_solve", "topk_compress"), label="EF21", dim=300,
          bits=lambda k: (UPLINK_BITS, DOWNLINK_BITS)):
    """Run one spec on the card through the user's entry points; check the
    ledger's integers of every round (``bits(k)`` gives a round's uplink and
    downlink bits at the uplink's k of that round), a decreasing loss, and
    one launch a round of each of ``kernels`` and none of the others; return
    the kernels' launch counts of that run and its history."""
    import torch

    from repro_torch.api import ExperimentSpec
    from repro_torch.kernels import LAUNCHES, reset_launches

    exp = ExperimentSpec(**spec_kw).build()
    check(exp.device.type == "cuda", exp.device)
    reset_launches()
    t0 = time.perf_counter()
    w, hist = exp.run(rounds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    check(exp.algo._use_sparse_center is sparse, "sparse center choice")
    check(w.shape == (dim,) and bool(torch.isfinite(w).all()),
          "finite iterate of the expected shape")
    loss = hist["loss"]
    check(len(loss) == rounds and all(map(math.isfinite, loss)), loss)
    check(all(b < a for a, b in zip(loss, loss[1:])), loss)
    expected = [bits(k) for k in hist["k_trajectory"]]
    per_round = [b - a for a, b in
                 zip([0] + hist["bits_cumulative"], hist["bits_cumulative"])]
    check(per_round == [up + down for up, down in expected], per_round)
    check(hist["uplink_bits"] == sum(up for up, _ in expected),
          hist["uplink_bits"])
    check(hist["downlink_bits"] == sum(down for _, down in expected),
          hist["downlink_bits"])
    check(launches == {name: rounds if name in kernels else 0
                        for name in launches}, launches)
    log(f"{label} run ({spec_kw['problem']}, {spec_kw['compressor']}, "
        f"{spec_kw['aggregator']}, {spec_kw['attack']}): {rounds} rounds in "
        f"{wall:.3f} s, loss {loss}, k {hist['k_trajectory']}, uplink "
        f"{hist['uplink_bits']} bits, downlink {hist['downlink_bits']} bits, "
        f"launches {launches}")
    return launches, hist


def check_small_against_cpu():
    """A small spec on the card (kernels) and on the CPU (plain versions),
    over the same data, for each rule of :data:`SMALL_RULES`: made once on
    the CPU and copied to the card (the CPU and CUDA generators draw
    different numbers from one seed)."""
    import numpy as np

    from repro_torch import interop
    from repro_torch.api import ExperimentSpec

    for rule in SMALL_RULES:
        spec = ExperimentSpec(**dict(SMALL, aggregator=rule))
        cpu = spec.build(device="cpu")
        card = spec.build(problem=interop.problem_from_reference(
            cpu.problem, device="cuda"))
        wg, hg = card.run(3)
        wc, hc = cpu.run(3)
        np.testing.assert_allclose(hg["loss"], hc["loss"], rtol=1e-4)
        np.testing.assert_allclose(wg.cpu().numpy(), wc.numpy(), atol=1e-4)
        for key in ("uplink_bits", "downlink_bits", "bits_cumulative"):
            check(hg[key] == hc[key], (rule, key))
        log(f"small spec, {rule}: card and CPU agree, loss {hg['loss']} vs "
            f"{hc['loss']}")


def check_small_large_d_against_cpu():
    """:data:`SMALL_LARGE_D` (d = 4352: the sharded top-k and the gridded
    center) on the card and on the CPU over the same data, 2 rounds: equal
    ledger integers, equal keep masks each round, loss within rtol 1e-5."""
    import numpy as np
    import torch

    from repro_torch import interop
    from repro_torch.api import ExperimentSpec

    spec = ExperimentSpec(**SMALL_LARGE_D)
    cpu = spec.build(device="cpu")
    card = spec.build(problem=interop.problem_from_reference(
        cpu.problem, device="cuda"))
    wg, hg = card.run(2)
    wc, hc = cpu.run(2)
    np.testing.assert_allclose(hg["loss"], hc["loss"], rtol=1e-5)
    for key in ("uplink_bits", "downlink_bits", "bits_cumulative"):
        check(hg[key] == hc[key], ("d = 4352", key))

    def keeps(exp):
        algo, p = exp.algo, exp.problem
        check(algo._use_sparse_center, "d = 4352 sparse center")
        w, v, st = p.w0, torch.zeros_like(p.w0), algo.init_comm_state()
        out = []
        for _ in range(2):
            w, v, st, info = algo.step(w, p.X_workers, p.y_workers, None, v,
                                       st)
            out.append(info["keep"].cpu())
        return out

    for kg, kc in zip(keeps(card), keeps(cpu)):
        check(torch.equal(kg, kc), ("d = 4352 keep masks", kg, kc))
    log(f"small spec at d = 4352 (sharded top-k, gridded center): card and "
        f"CPU agree, loss {hg['loss']} vs {hc['loss']}, equal keep masks")


def round_breakdown(spec_kw: dict = W8A, phases: bool = True,
                    label: str = "w8a") -> None:
    """Profile one round (``step``) of ``spec_kw`` on the card: the
    host-clock time, the device's busy time and share, the kernels by
    device time and the wire's and the center's kernels among them; then,
    with ``phases``, time the round's phases alone, with the peak memory of
    each."""
    import torch
    from torch.func import grad
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import ExperimentSpec
    from repro_torch.core import solve_cubic_gd

    exp = ExperimentSpec(**spec_kw).build()
    p, algo = exp.problem, exp.algo
    cfg = algo.config
    gen = torch.Generator(device="cuda").manual_seed(0)
    w, v, st, _ = algo.step(p.w0, p.X_workers, p.y_workers, gen)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        algo.step(w, p.X_workers, p.y_workers, gen, v, st)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((getattr(e, "device_time_total",
                            getattr(e, "cuda_time_total", 0.0)) / 1e3,
                    e.count, e.key[:90]) for e in prof.key_averages()),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows)
    top = "; ".join(f"{name} x{n}: {ms:.4f} ms" for ms, n, name in rows[:8])
    ours = ("krum_scores", "sort_workers", "sparse_agg", "topk_compress",
            "hist_kernel", "select_kernel", "count_kernel", "pack_kernel")
    center = "; ".join(f"{name} x{n}: {ms:.4f} ms" for ms, n, name in rows
                       if any(k in name for k in ours))
    log(f"one {label} round ({spec_kw['compressor']}, "
        f"{spec_kw['aggregator']}, {spec_kw['attack']}; step, profiled): "
        f"{wall_ms:.3f} ms on the host clock, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f} %); wire and center kernels: "
        f"{center or 'none'}; top kernels: {top}")
    if not phases:
        return

    X, y = p.X_workers, p.y_workers
    Xf, yf = X.reshape(-1, X.shape[-1]), y.reshape(-1)
    g = algo._worker_grads(w, X, y)
    H = algo._worker_hessians(w, X, y)
    phases = {
        "worker grads (vmap grad)": lambda: algo._worker_grads(w, X, y),
        "worker Hessians (closed form, bmm)":
            lambda: algo._worker_hessians(w, X, y),
        "cubic solve (kernel)": lambda: solve_cubic_gd(
            g, H, M=cfg.M, gamma=cfg.gamma, tol=cfg.solver_tol,
            max_iters=cfg.solver_iters),
        "full-data loss and gradient (run's history)":
            lambda: (p.loss_fn(w, Xf, yf), grad(p.loss_fn)(w, Xf, yf)),
    }
    parts = []
    for name, fn in phases.items():
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 3
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        parts.append(f"{name}: {ms:.3f} ms, peak +{peak:.0f} MiB")
    log(f"{label} round phases (host clock, synchronised, mean of 3): "
        + "; ".join(parts))


def time_kernels(inp: dict, launches: dict) -> list:
    import torch

    from repro_torch.kernels import (
        cubic_solve,
        cubic_solve_plain,
        krum_scores,
        krum_scores_plain,
        sort_workers,
        sort_workers_plain,
        topk_compress,
        topk_compress_plain,
    )

    g, H, lr, cfg, s, k = (inp[n] for n in ("g", "H", "lr", "cfg", "s", "k"))
    m, d = g.shape
    s0 = torch.zeros_like(g)
    kw = dict(M=cfg.M, gamma=cfg.gamma, tol=cfg.solver_tol,
              max_iters=cfg.solver_iters)
    _, iters = cubic_solve(g, H, s0, lr, **kw)
    n_iters = int(iters.sum())
    cubic_ms = cuda_ms(lambda: cubic_solve(g, H, s0, lr, **kw), reps=20)
    cubic_plain_ms = cuda_ms(lambda: cubic_solve_plain(g, H, s0, lr, **kw),
                             reps=3, warmup=1)
    # least work: each iteration's matvec (2d²) and its O(d) vector ops;
    # each input read and each output written once
    cubic_bound, cubic_by = bound_ms(4 * (m * d * d + 4 * m * d + 2 * m),
                                     n_iters * (2 * d * d + 8 * d))
    # the design's own traffic: every iteration streams its worker's H
    # (d² floats) from L2.  The card's L2 rate is not in the table, so the
    # time is given at the HBM rate, a ceiling on the L2 stream's time
    stream_bytes = 4 * n_iters * d * d
    stream_ms_at_hbm = stream_bytes / PEAK_BYTES_PER_S * 1e3

    topk_ms = cuda_ms(lambda: topk_compress(s, k), reps=200)
    topk_plain_ms = cuda_ms(lambda: topk_compress_plain(s, k), reps=200)
    topk_lib_ms = cuda_ms(lambda: torch.topk(s.abs(), k, dim=1), reps=200)
    # one compare per coordinate for each of the 31 pattern bits + the pack
    topk_bound, topk_by = bound_ms(4 * m * d + 8 * m * k, 32 * m * d)
    cubic_dev = kernel_device_ms(lambda: cubic_solve(g, H, s0, lr, **kw), 20,
                                 "cubic_solve_kernel")
    topk_dev = kernel_device_ms(lambda: topk_compress(s, k), 200,
                                "topk_compress_kernel")
    log(f"device time per launch (profiler): cubic_solve {cubic_dev} ms, "
        f"topk_compress {topk_dev} ms")
    center = inp["center"]
    cm, cd = center.shape
    krum_ms = cuda_ms(lambda: krum_scores(center, 4), reps=200)
    krum_plain_ms = cuda_ms(lambda: krum_scores_plain(center, 4), reps=200)
    krum_dev = kernel_device_ms(lambda: krum_scores(center, 4), 200,
                                "krum_scores_kernel")
    # each input read once, the scores written once; 3 operations per
    # coordinate of each of the m² pairs (difference, square, add)
    krum_bound, krum_by = bound_ms(4 * cm * cd + 4 * cm, 3 * cm * cm * cd)
    sort_ms = cuda_ms(lambda: sort_workers(center), reps=200)
    sort_plain_ms = cuda_ms(lambda: sort_workers_plain(center), reps=200)
    sort_lib_ms = cuda_ms(lambda: torch.sort(center, dim=0), reps=200)
    sort_dev = kernel_device_ms(lambda: sort_workers(center), 200,
                                "sort_workers_kernel")
    # the stack read and written once; a comparison sort's least work,
    # ⌈log₂ m⌉ compares per value
    sort_bound, sort_by = bound_ms(8 * cm * cd,
                                   cm * cd * math.ceil(math.log2(cm)))
    # the larger shapes of AGG_SHAPES, for how the two designs scale
    scaling = {}
    gen = torch.Generator(device="cuda").manual_seed(3)
    for sm, sd in AGG_SHAPES[3:]:
        x = torch.randn(sm, sd, generator=gen, device="cuda")
        scaling[f"{sm}x{sd}"] = {
            "krum_ms": cuda_ms(lambda: krum_scores(x, sm // 5), reps=20),
            "krum_device_ms": kernel_device_ms(
                lambda: krum_scores(x, sm // 5), 20, "krum_scores_kernel"),
            "krum_plain_ms": cuda_ms(lambda: krum_scores_plain(x, sm // 5),
                                     reps=5),
            "sort_ms": cuda_ms(lambda: sort_workers(x), reps=20),
            "sort_device_ms": kernel_device_ms(
                lambda: sort_workers(x), 20, "sort_workers_kernel"),
            "sort_plain_ms": cuda_ms(lambda: sort_workers_plain(x), reps=20),
            "torch_sort_ms": cuda_ms(lambda: torch.sort(x, dim=0), reps=20),
        }
    log(f"center kernels at larger stacks (ms): {json.dumps(scaling)}")
    log(f"center kernels on the w8a stack {tuple(center.shape)}: krum_scores "
        f"{krum_ms:.4f} ms per call, {krum_dev} ms device, plain "
        f"{krum_plain_ms:.4f} ms, bound {krum_bound:.7f} ms; sort_workers "
        f"{sort_ms:.4f} ms per call, {sort_dev} ms device, plain "
        f"{sort_plain_ms:.4f} ms, torch.sort {sort_lib_ms:.4f} ms, bound "
        f"{sort_bound:.7f} ms")
    log(f"cubic_solve {cubic_ms:.4f} ms ({n_iters} iterations over {m} "
        f"workers), plain {cubic_plain_ms:.4f} ms, bound {cubic_bound:.6f} "
        f"ms, H stream {stream_bytes} B = {stream_ms_at_hbm:.6f} ms at the "
        f"HBM rate; topk {topk_ms:.4f} ms, plain {topk_plain_ms:.4f} ms, "
        f"torch.topk {topk_lib_ms:.4f} ms, bound {topk_bound:.6f} ms")
    return [
        {"name": "cubic_solve", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/cubic_solve.cu",
         "replaces": "src/repro/kernels/cubic_step.py:48",
         "launches": launches["cubic_solve"],
         "max_abs_err": inp["cubic_err"], "ms": cubic_ms,
         "plain_ms": cubic_plain_ms, "bound_ms": cubic_bound,
         "bound_by": cubic_by, "library_ms": None,
         "device_ms": cubic_dev, "iterations": n_iters, "shape": [m, d],
         "stream_bytes": stream_bytes,
         "stream_ms_at_hbm": stream_ms_at_hbm},
        {"name": "topk_compress", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/topk_compress.cu",
         "replaces": "src/repro/kernels/topk_compress.py:191",
         "launches": launches["topk_compress"],
         "max_abs_err": inp["topk_err"], "ms": topk_ms,
         "plain_ms": topk_plain_ms, "bound_ms": topk_bound,
         "bound_by": topk_by, "library_ms": topk_lib_ms,
         "device_ms": topk_dev, "shape": [m, d], "k": k},
        {"name": "krum_scores", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/krum_scores.cu",
         "replaces": "src/repro/kernels/robust_agg.py:358",
         "launches": launches["krum_scores"],
         "max_abs_err": inp["krum_err"], "ms": krum_ms,
         "plain_ms": krum_plain_ms, "bound_ms": krum_bound,
         "bound_by": krum_by, "library_ms": None, "device_ms": krum_dev,
         "shape": [cm, cd], "n_byz": 4,
         "max_rel_err_over_shapes": inp["krum_rel"],
         "at_larger_shapes": {key: {k: v for k, v in rec.items()
                                    if k.startswith("krum")}
                              for key, rec in scaling.items()}},
        {"name": "sort_workers", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sort_workers.cu",
         "replaces": "src/repro/kernels/robust_agg.py:408",
         "launches": launches["sort_workers"],
         "max_abs_err": inp["sort_err"], "ms": sort_ms,
         "plain_ms": sort_plain_ms, "bound_ms": sort_bound,
         "bound_by": sort_by, "library_ms": sort_lib_ms,
         "device_ms": sort_dev, "shape": [cm, cd],
         "at_larger_shapes": {key: {k: v for k, v in rec.items()
                                    if not k.startswith("krum")}
                              for key, rec in scaling.items()}},
    ]


def time_gisette_kernels(inp: dict, launches: dict) -> list:
    """The records of the sharded top-k and the gridded center at drive A's
    shapes: the (20, 5000) updates at k = 500, and their (20, 500)
    payloads summed with the norm_trim keep as weights."""
    import torch

    from repro_torch.kernels import (
        aggregate_sparse_gridded,
        aggregate_sparse_plain,
        topk_compress_plain,
        topk_compress_sharded,
    )

    s, k, vals, idx, keep = (inp[n] for n in ("s", "k", "vals", "idx",
                                                "keep"))
    m, d = s.shape
    passes = ("hist_kernel", "select_kernel", "count_kernel", "pack_kernel",
              "Memset")
    topk_ms = cuda_ms(lambda: topk_compress_sharded(s, k), reps=200)
    topk_plain_ms = cuda_ms(lambda: topk_compress_plain(s, k), reps=50)
    topk_lib_ms = cuda_ms(lambda: torch.topk(s.abs(), k, dim=1), reps=200)
    topk_dev = device_ms_by_name(lambda: topk_compress_sharded(s, k), 200,
                                 passes)
    # x read once and the payload written once; per coordinate three
    # histogram updates and the sure/tie compares
    topk_bound, topk_by = bound_ms(4 * m * d + 8 * m * k, 5 * m * d)
    agg_ms = cuda_ms(lambda: aggregate_sparse_gridded(vals, idx, d, keep),
                     reps=200)
    agg_plain_ms = cuda_ms(lambda: aggregate_sparse_plain(vals, idx, d, keep),
                           reps=50)
    lib_idx = idx.reshape(-1).long()
    lib_vals = (vals * keep[:, None]).reshape(-1)
    agg_lib_ms = cuda_ms(lambda: torch.zeros(d, device=s.device).index_add_(
        0, lib_idx, lib_vals), reps=200)
    agg_dev = device_ms_by_name(
        lambda: aggregate_sparse_gridded(vals, idx, d, keep), 200,
        ("sparse_agg_kernel",))
    # the payloads and weights read once, the aggregate written once; a
    # multiply and an add per payload entry
    agg_bound, agg_by = bound_ms(8 * m * k + 4 * m + 4 * d, 2 * m * k)
    log(f"topk_compress_sharded at ({m}, {d}), k = {k}: {topk_ms:.4f} ms a "
        f"call, device by pass {topk_dev}, plain {topk_plain_ms:.4f} ms, "
        f"torch.topk {topk_lib_ms:.4f} ms, bound {topk_bound:.7f} ms; "
        f"aggregate_sparse_gridded of ({m}, {k}) over d = {d}: {agg_ms:.4f} "
        f"ms a call, device {agg_dev}, plain {agg_plain_ms:.4f} ms, "
        f"index_add_ {agg_lib_ms:.4f} ms, bound {agg_bound:.7f} ms")
    return [
        {"name": "topk_sharded", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/topk_sharded.cu",
         "replaces": "src/repro/kernels/topk_compress.py:299",
         "replaces_passes": ["src/repro/kernels/topk_compress.py:299",
                             "src/repro/kernels/topk_compress.py:331"],
         "launches": launches["topk_sharded"],
         "max_abs_err": inp["topk_err"], "ms": topk_ms,
         "plain_ms": topk_plain_ms, "bound_ms": topk_bound,
         "bound_by": topk_by, "library_ms": topk_lib_ms,
         "device_ms": sum(v for key, v in topk_dev.items()
                          if key in passes[:4] and v is not None),
         "device_ms_by_pass": topk_dev, "shape": [m, d], "k": k},
        {"name": "sparse_agg", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sparse_agg.cu",
         "replaces": "src/repro/kernels/robust_agg.py:245",
         "launches": launches["sparse_agg"],
         "max_abs_err": inp["agg_err"], "ms": agg_ms,
         "plain_ms": agg_plain_ms, "bound_ms": agg_bound,
         "bound_by": agg_by, "library_ms": agg_lib_ms,
         "device_ms": agg_dev["sparse_agg_kernel"],
         "device_ms_call": agg_dev["all"], "shape": [m, k], "d": d},
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import ExperimentSpec
    from repro_torch.kernels import build_all

    t_start = t0 = time.perf_counter()
    libs = build_all()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    card = card_line()
    log(f"card: {card}")

    t0 = time.perf_counter()
    exp = ExperimentSpec(**W8A).build()
    torch.cuda.synchronize()
    log(f"w8a problem on {torch.cuda.get_device_name(0)}: X_workers "
        f"{tuple(exp.problem.X_workers.shape)} in "
        f"{time.perf_counter() - t0:.2f} s")
    exp.algo._ensure_channels(exp.problem.dim, exp.problem.m_workers)
    inputs = check_kernels(exp)
    del exp
    inputs["center"] = center_stack(inputs)
    inputs.update(check_agg_kernels(inputs["center"]))

    launches, _ = drive(W8A, 5, sparse=False)
    sparse_launches, _ = drive(W8A_SPARSE, 3, sparse=True,
                               label="sparse-center")
    rule_launches = {}
    for rule, kernel in W8A_RULES.items():
        rule_launches[rule], _ = drive(
            dict(W8A, attack="gaussian", aggregator=rule), 3, sparse=False,
            kernels=("cubic_solve", "topk_compress", kernel),
            label=rule.partition(":")[0])

    # gisette's width: the sharded top-k and the gridded center
    ginp = check_gisette_kernels()
    check((gisette_uplink_bits(500), GISETTE_DOWNLINK_BITS)
          == (450000, 160000), "gisette ledger rule")
    a_launches, _ = drive(
        DRIVE_A, 3, sparse=True, dim=GISETTE_D, label="gisette sparse-center",
        kernels=("cubic_solve", "topk_sharded", "sparse_agg"),
        bits=lambda k: (gisette_uplink_bits(500), GISETTE_DOWNLINK_BITS))
    b_launches, b_hist = drive(
        DRIVE_B, 4, sparse=False, dim=GISETTE_D, label="gisette adaptive-k",
        kernels=("cubic_solve", "topk_sharded"),
        bits=lambda k: (gisette_uplink_bits(k), GISETTE_DOWNLINK_BITS))
    check(len(set(b_hist["k_trajectory"])) > 1,
          ("adaptive k must move", b_hist["k_trajectory"]))
    check_small_against_cpu()
    check_small_large_d_against_cpu()

    # each kernel's launches in the first run that drives it
    runs = {"ef21_norm_trim_5_rounds": launches,
            "sparse_center_3_rounds": sparse_launches,
            **{f"{rule}_3_rounds": n for rule, n in rule_launches.items()},
            "gisette_sparse_center_3_rounds": a_launches,
            "gisette_adaptive_k_4_rounds": b_launches}
    first = {name: next((n[name] for n in runs.values() if n[name]), 0)
             for name in launches}
    kernels = time_kernels(inputs, first)
    kernels[0]["at_gisette"] = ginp["cubic"]
    kernels += time_gisette_kernels(ginp, first)
    round_breakdown(DRIVE_A, label="gisette (d = 5000) sparse-center")
    round_breakdown()
    for rule in W8A_RULES:
        round_breakdown(dict(W8A, attack="gaussian", aggregator=rule),
                        phases=False)
    for rec in kernels:
        rec["launches_by_run"] = {run: n[rec["name"]]
                                  for run, n in runs.items()}
    log(f"finished in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
