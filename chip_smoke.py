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
5. runs a small spec on the card and on the CPU (plain versions), over the
   same data, and holds the two against each other, for norm_trim and each
   kernel head of the comparison rules;
6. times each kernel call, its plain version and, where one PyTorch call
   computes the same function (``torch.topk``, ``torch.sort``), that call
   with CUDA events (``ms``, ``plain_ms``, ``library_ms``: per call, host
   launch overhead included), the kernels alone with ``torch.profiler``
   (``device_ms``), and works out each kernel's bound from this run's
   inputs; then profiles one w8a round of each spec.

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


def kernel_device_ms(fn, reps: int, kernel: str):
    """Mean device milliseconds of the CUDA kernel whose name contains
    ``kernel``, per call of ``fn``, from a ``torch.profiler`` trace (None
    when the trace shows no device time for it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for evt in prof.key_averages():
        if kernel in evt.key:
            total_us += getattr(evt, "device_time_total",
                                getattr(evt, "cuda_time_total", 0.0))
    return total_us / 1e3 / reps if total_us > 0 else None


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def w8a_solver_inputs(exp):
    """The cubic solve's inputs in the w8a run's first round: every
    worker's g and H at w0, and the step sizes."""
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

    g, H, lr, cfg = w8a_solver_inputs(exp)
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


def drive(spec_kw: dict, rounds: int, *, sparse: bool,
          kernels=("cubic_solve", "topk_compress"), label="EF21"):
    """Run one spec on the card through the user's entry points; check one
    launch a round of each of ``kernels`` and none of the others; return
    the kernels' launch counts of that run."""
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
    check(w.shape == (300,) and bool(torch.isfinite(w).all()),
          "finite iterate of the expected shape")
    loss = hist["loss"]
    check(len(loss) == rounds and all(map(math.isfinite, loss)), loss)
    check(all(b < a for a, b in zip(loss, loss[1:])), loss)
    per_round = [b - a for a, b in
                 zip([0] + hist["bits_cumulative"], hist["bits_cumulative"])]
    check(per_round == [UPLINK_BITS + DOWNLINK_BITS] * rounds, per_round)
    check(hist["uplink_bits"] == UPLINK_BITS * rounds, hist["uplink_bits"])
    check(hist["downlink_bits"] == DOWNLINK_BITS * rounds,
          hist["downlink_bits"])
    check(launches == {name: rounds if name in kernels else 0
                        for name in launches}, launches)
    log(f"{label} w8a run ({spec_kw['aggregator']}, {spec_kw['attack']}): "
        f"{rounds} rounds in {wall:.3f} s, loss {loss}, uplink "
        f"{hist['uplink_bits']} bits, downlink {hist['downlink_bits']} bits, "
        f"launches {launches}")
    return launches


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


def round_breakdown(spec_kw: dict = W8A, phases: bool = True) -> None:
    """Profile one w8a round (``step``) of ``spec_kw`` on the card: the
    host-clock time, the device's busy time and share, the kernels by
    device time and the center's kernels among them; then, with
    ``phases``, time the round's phases alone, with the peak memory of
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
    center = "; ".join(f"{name} x{n}: {ms:.4f} ms" for ms, n, name in rows
                       if "krum_scores" in name or "sort_workers" in name)
    log(f"one w8a round ({spec_kw['aggregator']}, {spec_kw['attack']}; step, "
        f"profiled): {wall_ms:.3f} ms on the host clock, device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f} %); center kernels:"
        f" {center or 'none'}; top kernels: {top}")
    if not phases:
        return

    X, y = p.X_workers, p.y_workers
    Xf, yf = X.reshape(-1, X.shape[-1]), y.reshape(-1)
    g = algo._worker_grads(w, X, y)
    H = algo._worker_hessians(w, X, y)
    phases = {
        "worker grads (vmap grad)": lambda: algo._worker_grads(w, X, y),
        "worker Hessians (vmap hessian)":
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
    log("w8a round phases (host clock, synchronised, mean of 3): "
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import ExperimentSpec
    from repro_torch.kernels import build_all

    t0 = time.perf_counter()
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

    launches = drive(W8A, 5, sparse=False)
    sparse_launches = drive(W8A_SPARSE, 3, sparse=True,
                            label="sparse-center")
    rule_launches = {}
    for rule, kernel in W8A_RULES.items():
        rule_launches[rule] = drive(
            dict(W8A, attack="gaussian", aggregator=rule), 3, sparse=False,
            kernels=("cubic_solve", "topk_compress", kernel),
            label=rule.partition(":")[0])
    check_small_against_cpu()

    # each kernel's launches in the first run that drives it
    first = dict(launches)
    for runs in rule_launches.values():
        for name, n in runs.items():
            first[name] = first[name] or n
    kernels = time_kernels(inputs, first)
    round_breakdown()
    for rule in W8A_RULES:
        round_breakdown(dict(W8A, attack="gaussian", aggregator=rule),
                        phases=False)
    for rec in kernels:
        rec["launches_by_run"] = {
            "ef21_norm_trim_5_rounds": launches[rec["name"]],
            "sparse_center_3_rounds": sparse_launches[rec["name"]],
            **{f"{rule}_3_rounds": runs[rec["name"]]
               for rule, runs in rule_launches.items()}}
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
