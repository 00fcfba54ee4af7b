#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

From the root of a checkout, with one card.  In order it:

1. builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together);
2. prints the card's name and power limit;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes of the w8a run (top-k exactly, ties included, and over the edge
   stacks of :data:`TOPK_EDGE_SINGLE`, one launch a call; the cubic solve
   within an absolute 1e-5 and one iteration, the bound the CPU parity tests
   use for Algorithm 2: one iteration more or less at the tolerance boundary
   moves s by at most lr·tol, and the cluster's sums run in another
   order); then the center's kernels over (m, d) in :data:`AGG_SHAPES`,
   :data:`AGG_WIDE_SHAPES` (the reference's model-scale roofline ladder, up
   to a 512 MB stack) and :data:`AGG_LIMIT_SHAPES` (m = 16384, the
   kernels' limit): the worker sort bit for bit (ties, ±0, ±inf and a NaN
   column included; also against the CPU's stable sort over
   :data:`AGG_SHAPES`), krum's scores within rtol 1e-5 (distances summed
   in another order) and exactly on an integer stack, its d2 bitwise
   symmetric (read through the launch helper ``krum_scores`` uses), and
   krum's argmin wherever the two best scores differ by more than that;
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
   F1: the sparse center's determinism at w8a's width.  One round's
   payloads (20, 30) with their norm_trim keep weights, summed on the card
   twice by ``index_add_`` and on the CPU by the plain version, bit for bit
   (what it finds is logged), then by ``aggregate_sparse`` on the card twice
   and on the CPU, which must agree bit for bit; and :data:`W8A_SPARSE` for
   3 rounds on the card and on the CPU over the same arrays: equal ledger
   integers and equal keep masks each round;
5. at gisette's width (d = 5000, LIBSVM's ``gisette``: 6000 rows, here a
   synthetic twin over m = 20 workers of 300 rows, :data:`DRIVE_A`), holds
   the cubic solve against its plain version on the first round's g and H,
   the sharded top-k against its plain version bit for bit over
   :data:`SHARDED_TOPK_SHAPES` (the round's own (20, 5000) updates, normal
   and tie-heavy rows) and the edge stacks of :data:`TOPK_EDGE_SHARDED` (a
   cluster of 8; a cluster of 16 whose slices outgrow shared memory), and
   the sparse center bit
   for bit over
   :data:`SPARSE_AGG_SHAPES` (the round's own (20, 500) payloads, with 0/1
   weights and without; w8a's width; duplicates within rows and across
   workers at d ≤ 4096, through ``aggregate_sparse``); then drives A (sparse
   center, 3 rounds) and B (adaptive top-k with EF21, 4 rounds), with the
   same checks as the w8a drives, the bits of B following its k, which
   must move; then the cubic solve against its plain version at the widths
   of :data:`CUBIC_WIDTHS` (H resident in shared memory and streamed, d no
   multiple of 4), at :data:`CUBIC_GLOBAL_S` (the iterate in device
   memory), and at d = 10000, m = 20 (:data:`WIDE`, 8 GB of Hessians, past the 8192
   floats a CTA once held; freed after), one launch a call;
6. runs small specs on the card and on the CPU (plain versions), over the
   same data, and holds the two against each other: for norm_trim and each
   kernel head of the comparison rules, and at d = 4352 for the sharded
   top-k and the sparse center (:data:`SMALL_LARGE_D`, keep masks too);
7. the model zoo's dense decoder (slice 4): holds RMSNorm and flash
   attention against their plain versions at gemma3-27b's shapes
   (:data:`RMS_SHAPES`, :data:`FLASH_CASES`; float32 within 1e-5, bf16
   within rtol 2^-7 and atol 1e-5), flash attention also at
   recurrentgemma-9b's Dh = 256 (:data:`FLASH_WIDE_HEADS`, bf16 and
   float32) and with a flat and a peaked softmax
   (:data:`FLASH_Q_SCALES`), and counts the ``HGMMA`` instructions of the
   built flash library (the bf16 route's ``wgmma``; there must be some);
   runs a reduced gemma3 with grouped kv heads on the card and on the CPU
   over the same weights (forward and 20 greedy tokens); serves
   gemma3-27b at full width through ``launch.serve.run_serving``
   (:data:`SERVE`: 28.42 B bf16 parameters made on the card, batch 4, 32
   prompt tokens through the decode path and 32 greedy ones), asserting
   125 RMSNorm launches a decode step and no other; then
   ``Model.forward`` on a (1, 4096) prompt, asserting 62 flash attention
   and 125 RMSNorm launches, each block and the logits held against the
   same weights through the plain versions
   (:data:`BLOCK_REL_TOL`, the plain forward's own one-ulp spread), each
   block's norms and attention through the kernels on the plain calls'
   inputs (bf16 tolerance above), and
   the first 6 layers' bf16 logits against their float32 forward;
8. times each kernel call (the cubic solve at w8a and at d = 5000, the
   sparse center at w8a and at drive A, krum and the worker sort at the w8a
   stack and :data:`AGG_TIMED_SHAPES`, each with its launch plan), its
   plain version and, where one
   PyTorch call computes the same function (``torch.topk``, ``torch.sort``,
   ``index_add_``, ``F.rms_norm``, ``F.scaled_dot_product_attention``),
   that call with CUDA events (``ms``, ``plain_ms``, ``library_ms``: per
   call, host launch overhead included), the kernels and the library
   calls alone with ``torch.profiler`` (``device_ms``,
   ``library_device_ms``; flash attention's the median of
   :data:`DEVICE_RUNS` runs, at gemma3-27b's global and local layers and
   recurrentgemma-9b's heads, by CUDA events around single calls where
   the profiler's traces keep showing no event of the kernel; the cubic solve also in the launch
   plans of :data:`CUBIC_SWEEP_W8A` and :data:`CUBIC_SWEEP_GISETTE`, taken
   in turn, three readings each), and
   works out each kernel's bound from this run's inputs; times the top-k
   calls of :data:`TOPK_TIMED` (:func:`time_topk`: the device span of a
   call, one kernel and nothing else, ``torch.topk`` beside it, and the
   cluster kernel at other cluster sizes); then profiles one round of drive A and
   of each w8a spec.

The line before the last carries the card's name and power limit, the one
before it the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device it exits 1 before doing anything.
"""
from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
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
# each.  A: the sparse center, through the sharded top-k and the sparse
# center's kernel; B: adaptive top-k through the sharded kernel at a moving
# k, EF21, a dense center
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
# the top-k kernels over the edge stacks (:func:`topk_edge_stacks`) at
# k = 1, d / 10 and d: the single tile's (m, d), then the cluster kernel's,
# a cluster of 8 at (1, 131072) and at (2, 1,000,000) a cluster of 16 (the
# non-portable size) whose slices outgrow shared memory
TOPK_EDGE_SINGLE = ((20, 1), (20, 300), (1000, 300), (20, 1408))
TOPK_EDGE_SHARDED = ((1, 1409), (20, 1409), (20, 5000), (3, 65537),
                     (1, 131072), (2, 1_000_000))
# the top-k calls timed (m, d, k): the w8a round's, drive A's, the mesh
# runtime's (2, 65536) and the reference's top-k ladder at ratio 0.1
# (benchmarks/table1_communication.py KERNEL_TIMING_DS, one row)
TOPK_TIMED = ((20, 300, 30), (20, 5000, 500), (2, 65536, 6553),
              (1, 16384, 1638), (1, 131072, 13107), (1, 1_000_000, 100_000))
# (m, k, d, duplicate indices within rows and across workers): drive A's
# payloads, w8a's width, and d ≤ 4096 (the reference's scatter width)
SPARSE_AGG_SHAPES = ((20, 500, 5000, False), (20, 30, 300, False),
                     (16, 100, 4096, True), (8, 64, 8192, True),
                     (3, 16, 65537, False))
# the cubic solve against its plain version at these widths (m = 20):
# H resident in shared memory up to 301, streamed beyond; d = 1, 123, 301
# and 1001 no multiple of 4
CUBIC_WIDTHS = (1, 123, 300, 301, 1001, 4352, 5000)
# (m, d) where the rules keep the iterate in device memory: past d = 28544
# (3.26 GB of H), iterations capped
CUBIC_GLOBAL_S = (1, 28545)
CUBIC_GLOBAL_S_ITERS = 100
# the cubic kernel's device time in launch plans, the rules' pick among
# them, on the same inputs as its record: (cluster size, mode) at w8a and
# at d = 5000
CUBIC_SWEEP_W8A = ((2, "resident"), (3, "resident"), (4, "resident"),
                   (5, "resident"), (6, "resident"), (8, "resident"),
                   (8, "streamed"))
CUBIC_SWEEP_GISETTE = ((4, "streamed"), (6, "streamed"), (8, "streamed"),
                       (16, "streamed"), (8, "streamed_global_s"))
# past the 8192 floats a CTA once held: d = 10000, m = 20 (8 GB of
# Hessians), a synthetic logistic problem of gisette's shape made wider
WIDE = dict(GISETTE, problem="synthetic-logistic:6000:10000",
            compressor="topk_kernel:0.1", error_feedback="none",
            attack="flipped_label")
WIDE_D = 10000
# F1: how often index_add_ sums the w8a payloads on the card, for the record
F1_INDEX_ADD_RUNS = 10
# a spec past both single-tile bounds, small enough for the CPU
SMALL_LARGE_D = dict(problem="synthetic-logistic:512:4352", m_workers=4,
                     solver_iters=100, compressor="topk_kernel:0.1",
                     error_feedback="none", aggregator="norm_trim:0.4",
                     attack="flipped_label", alpha=0.25)
CUBIC_ATOL = 1e-5
# and each worker's s within this share of its norm: the smallest workers'
# entries are about 1e-5, the size of CUBIC_ATOL
CUBIC_RTOL = 1e-4
# the center's kernels: the w8a stack, odd shapes, m = 256 (the reference
# kernel's on-chip bound) and m > 256
AGG_SHAPES = ((3, 1), (20, 300), (33, 513), (256, 4096), (300, 300))
# the reference's aggregation roofline ladder (benchmarks/
# table1_communication.py): model-scale update vectors, the largest a 512 MB
# stack; then the sort's columns wider than a warp and the kernels' limit,
# m = 16384
AGG_WIDE_SHAPES = ((32, 131072), (128, 1_000_000))
AGG_LIMIT_SHAPES = ((2048, 512), (16384, 8))
# the center kernels timed beyond the w8a stack
AGG_TIMED_SHAPES = ((300, 300), (256, 4096), (32, 131072), (128, 1_000_000))
KRUM_RTOL = 1e-5

# Slice 4, the model zoo's dense decoder: gemma3-27b at full width (62
# layers in 5:1 local:global units, window 1024, d_model 5376, 32 query and
# 16 kv heads of 128, d_ff 21504, vocab 262144; 28.42 B parameters, bf16),
# served as launch/serve.py's defaults serve it, then one batched prefill
SERVE = dict(arch="gemma3-27b", preset="full", batch=4, prompt_len=32,
             gen=32)
GEMMA_PARAMS = 28_417_605_888
GEMMA_LAYERS = 62
NORMS_PER_PASS = 2 * GEMMA_LAYERS + 1      # two a block and the final norm
PREFILL_LEN = 4096
# the kernels' own checks: RMSNorm at the prefill and decode shapes; flash
# attention at the prefill shape, global (window 0) and local (1024), and
# at an S that is no multiple of the kernel's 64-row tile
RMS_SHAPES = ((PREFILL_LEN, 5376), (SERVE["batch"], 5376))
FLASH_HEADS = (32, 16, 128)
FLASH_CASES = ((PREFILL_LEN, 0), (PREFILL_LEN, 1024), (4000, 0), (4000, 1024))
# recurrentgemma-9b's attention: 16 query heads, one kv head, Dh = 256,
# window 2048 (held in bf16 at S = 4096 and float32 at S = 4000, timed in
# bf16 at S = 4096)
FLASH_WIDE_HEADS = (16, 1, 256)
FLASH_WIDE_WINDOW = 2048
# the bf16 kernel's split of P into two bf16 halves, stressed by a flat
# softmax (q scaled by 0.01: outputs near zero, the mean of up to 4096 v
# rows) and a peaked one (q scaled by 8), at gemma3-27b's global layer
FLASH_Q_SCALES = (0.01, 8.0)
# flash attention's device times: the median of this many profiler runs,
# each made at most PROFILE_TRIES times while its trace shows no event of
# the kernel.  Every profiler window is padded by PROFILE_PAD_S of host
# time on each side, so that a kernel near the window's edge is not lost
# to the skew between the host's and the card's clocks.
DEVICE_RUNS = 5
PROFILE_TRIES = 3
PROFILE_PAD_S = 0.02
# device spans of single calls (top-k): each call runs in a profiler range
# of this name, after a few calls outside any, and is followed by this much
# host sleep; the trace's categories of device work
SPAN_GAP_S = 0.002
SPAN_WARMUP = 3
SPAN_MARK = "chip_smoke_span_call"
DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")
# the model kernels against their plain versions: float32 within 1e-5; bf16
# within rtol 2^-7 (one to two bf16 ulps: kernel and plain version differ
# only in the order of their float32 sums before the cast) and atol 1e-5
F32_TOL = 1e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5
# the bf16 forward through the kernels against the same forward through the
# plain versions.  Both round to bf16 after every product and norm; where
# they round apart (2^-8 relative) the difference runs on through the 62
# layers, as any one-ulp difference does in this network.  So: each block,
# given the same input, within 2^-7 relative (Frobenius) of the plain
# block; the logits no further from the plain forward's than the plain
# forward's own move when its embeddings move by one bf16 ulp; and over the
# first 6 layers, the bf16 logits through the kernels as close to the
# float32 forward's as the bf16 plain forward's, within 10 %
BLOCK_REL_TOL = 2.0 ** -7
CUT_DEPTH_SLACK = 1.1
# a reduced gemma3 with grouped kv heads, run on the card and on the CPU
SMALL_MODEL_KV_HEADS = 2

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, non-tensor fp32 ops/s
# and dense bf16 tensor-core ops/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12


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
        time.sleep(PROFILE_PAD_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
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


def event_ms_per_call(fn, reps: int) -> float:
    """Median milliseconds of one call of ``fn`` between two CUDA events
    recorded just before and just after it, over ``reps`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def median_device_ms(fn, reps: int, kernel: str) -> dict:
    """:func:`kernel_device_ms` over :data:`DEVICE_RUNS` profiler runs: the
    median and the range, under ``"by": "profiler"``.  A run whose trace
    shows no event of ``kernel`` is made again, up to
    :data:`PROFILE_TRIES` times in all.  If one still shows none, every run
    is timed by CUDA events around single calls instead
    (:func:`event_ms_per_call`, launch gaps included), under
    ``"by": "cuda_events"``."""
    runs, empty = [], 0
    for _ in range(DEVICE_RUNS):
        for _ in range(PROFILE_TRIES):
            ms = kernel_device_ms(fn, reps, kernel)
            if ms is not None:
                break
            empty += 1
        runs.append(ms)
    by = "profiler"
    if None in runs:
        log(f"{kernel}: {empty} profiler runs showed no event of it; its "
            f"device times are taken by CUDA events instead")
        runs = [event_ms_per_call(fn, reps) for _ in range(DEVICE_RUNS)]
        by = "cuda_events"
    elif empty:
        log(f"{kernel}: {empty} profiler runs showed no event of it and "
            f"were made again")
    return {"median": statistics.median(runs), "min": min(runs),
            "max": max(runs), "by": by, "empty_traces": empty}


def device_span_ms(fn, reps: int) -> dict:
    """Per call of ``fn``, each on an idle card (a synchronise and
    :data:`SPAN_GAP_S` of host sleep after it): the device span from its
    first device event's start to its last one's end, so the gaps inside a
    chain of launches count (``span_ms``), the sum of its events' durations
    (``busy_ms``) and of its kernels' alone (``kernel_ms``), medians over
    ``reps`` calls, and the device events (kernels, memsets, copies) a call
    runs (``events``).  From a ``torch.profiler`` trace exported as Chrome
    JSON: each call runs inside a ``record_function`` range, after
    :data:`SPAN_WARMUP` calls outside any (a trace may miss the device
    events of its first calls), and a device event belongs to the last
    range that starts before it (the calls are :data:`SPAN_GAP_S` apart, so
    half of that absorbs the skew between the host's and the card's
    clocks).  A trace in which a call shows no device event is taken again,
    up to :data:`PROFILE_TRIES` times."""
    import bisect

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    skew = SPAN_GAP_S * 1e6 / 2
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for i in range(SPAN_WARMUP + reps):
                with (record_function(SPAN_MARK) if i >= SPAN_WARMUP
                      else contextlib.nullcontext()):
                    fn()
                torch.cuda.synchronize()
                time.sleep(SPAN_GAP_S)
            time.sleep(PROFILE_PAD_S)
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            trace = json.loads(path.read_text()).get("traceEvents", [])
        starts = sorted(float(e["ts"]) for e in trace
                        if e.get("ph") == "X" and e.get("name") == SPAN_MARK
                        and e.get("cat") == "user_annotation")
        calls = [[] for _ in starts]
        for e in trace:
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
                ts = float(e["ts"])
                i = bisect.bisect_right(starts, ts + skew) - 1
                if i >= 0:
                    calls[i].append((ts, ts + float(e["dur"]),
                                     e["cat"] == "kernel"))
        if len(calls) == reps and all(calls):
            break
    check(len(calls) == reps and all(calls),
          ("device events of every call", reps, [len(c) for c in calls]))
    return {"span_ms": statistics.median(
                (max(e for _, e, _ in c) - min(b for b, _, _ in c)) / 1e3
                for c in calls),
            "busy_ms": statistics.median(
                sum(e - b for b, e, _ in c) / 1e3 for c in calls),
            "kernel_ms": statistics.median(
                sum(e - b for b, e, kern in c if kern) / 1e3 for c in calls),
            "events": statistics.median(len(c) for c in calls)}


def library_device_ms(fn, reps: int):
    """Mean device milliseconds per call of every kernel and copy that the
    library call ``fn`` runs."""
    return device_ms_by_name(fn, reps, ())["all"]


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = PEAK_OPS_PER_S):
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_ops / ops_per_s
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


def cubic_close(s, iters, ps, piters, lr, tol, what):
    """A cubic solve against the plain version's: s finite and within
    :data:`CUBIC_ATOL`, iteration counts within one, and each worker's s
    within :data:`CUBIC_RTOL` of its norm (plus 2·lr·tol, the most one
    iteration more at the stop boundary moves it, where the counts differ).
    Returns the largest |Δs|."""
    import torch

    check(s.shape == ps.shape and bool(torch.isfinite(s).all()),
          (what, "finite solve of the expected shape"))
    err = float((s - ps).abs().max())
    check(err <= CUBIC_ATOL, (what, err))
    check(int((iters - piters).abs().max()) <= 1,
          (what, iters.tolist(), piters.tolist()))
    slack = torch.where(iters == piters, 0.0, 2 * lr * max(tol, 0.0))
    gap = torch.linalg.vector_norm(s - ps, dim=1)
    bound = CUBIC_RTOL * torch.linalg.vector_norm(ps, dim=1) + slack
    check(bool((gap <= bound).all()),
          (what, "per-worker", (gap / bound).max().item()))
    return err


def hold_cubic(g, H, s0, lr, what, **kw):
    """The cubic kernel against its plain version on the same inputs: one
    launch and :func:`cubic_close`.  Returns (largest |Δs|, s, the kernel's
    and the plain version's iterations)."""
    import torch

    from repro_torch.kernels import LAUNCHES, cubic_solve, cubic_solve_plain

    before = LAUNCHES["cubic_solve"]
    s, iters = cubic_solve(g, H, s0, lr, **kw)
    torch.cuda.synchronize()
    check(LAUNCHES["cubic_solve"] == before + 1, (what, "one launch"))
    ps, piters = cubic_solve_plain(g, H, s0, lr, **kw)
    err = cubic_close(s, iters, ps, piters, lr, kw["tol"], what)
    return err, s, iters, piters


def cubic_case(m: int, d: int, seed: int):
    """A cubic sub-problem stack on the card: per worker a non-symmetric H
    (a symmetric random part, positive definite for even workers and a
    saddle for odd ones, plus a small non-symmetric part), gradients of
    scales 1 to 1e-3 and step sizes in [0.1, 0.25], so that the workers
    stop at different iterations."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    H = torch.empty(m, d, d, device="cuda")
    for w in range(m):
        A = torch.randn(d, d, generator=gen, device="cuda")
        B = torch.randn(d, d, generator=gen, device="cuda")
        H[w] = (A + A.T) / (2 * d ** 0.5) + 0.05 * B / d ** 0.5
        if w % 2 == 0:
            H[w].diagonal().add_(2.0)
        del A, B
    g = torch.randn(m, d, generator=gen, device="cuda") / d ** 0.5
    g *= torch.logspace(0, -3, m, device="cuda")[:, None]
    lr = 0.1 + 0.15 * torch.rand(m, generator=gen, device="cuda")
    return g, H, lr


CUBIC_CASE_KW = dict(M=10.0, gamma=1.0, tol=1e-6, max_iters=300)


def check_cubic_widths() -> dict:
    """The cubic kernel against its plain version at :data:`CUBIC_WIDTHS`
    (m = 20) and at :data:`CUBIC_GLOBAL_S`, in the plans its rules pick,
    from s = 0 and then one step from the kernel's answer; returns each
    width's plan and errors."""
    import torch

    from repro_torch.kernels import cubic_plan, cubic_solve, cubic_solve_plain

    out = {}
    cases = [(20, d, CUBIC_CASE_KW) for d in CUBIC_WIDTHS]
    cases.append((*CUBIC_GLOBAL_S,
                  dict(CUBIC_CASE_KW, max_iters=CUBIC_GLOBAL_S_ITERS)))
    for m, d, kw in cases:
        g, H, lr = cubic_case(m, d, seed=d)
        plan = cubic_plan(m, d)
        err, s, it, _ = hold_cubic(g, H, torch.zeros_like(g), lr,
                                   ("cubic width", m, d), **kw)
        one, _ = cubic_solve(g, H, s, lr, M=10.0, gamma=1.0, tol=-1.0,
                             max_iters=1)
        p1, _ = cubic_solve_plain(g, H, s, lr, M=10.0, gamma=1.0, tol=-1.0,
                                  max_iters=1)
        step_err = float((one - p1).abs().max())
        check(step_err <= 1e-6, ("cubic step", m, d, step_err))
        out[f"{m}x{d}"] = {"cluster": plan.cluster, "mode": plan.mode,
                           "max_abs_err": err, "step_err": step_err,
                           "iterations": [int(it.min()), int(it.max())]}
        del g, H, s, one, p1
        torch.cuda.empty_cache()
    modes = {v["mode"] for v in out.values()}
    check(modes == {"resident", "streamed", "streamed_global_s"}, modes)
    log(f"cubic_solve within {CUBIC_ATOL} (and {CUBIC_RTOL} of each "
        f"worker's norm) and one iteration of its plain version at every "
        f"width, in each mode, one launch a call: {json.dumps(out)}")
    return out


def check_cubic_wide() -> dict:
    """The cubic solve at d = 10000, m = 20 (:data:`WIDE`'s first round: 8 GB
    of closed-form Hessians) against its plain version; then frees them."""
    import torch

    from repro_torch.api import ExperimentSpec
    from repro_torch.kernels import cubic_plan

    exp = ExperimentSpec(**WIDE).build()
    g, H, lr, cfg = first_round_solver_inputs(exp)
    check(tuple(H.shape) == (20, WIDE_D, WIDE_D), tuple(H.shape))
    kw = dict(M=cfg.M, gamma=cfg.gamma, tol=cfg.solver_tol,
              max_iters=cfg.solver_iters)
    plan = cubic_plan(20, WIDE_D)
    t0 = time.perf_counter()
    err, _, it, pit = hold_cubic(g, H, torch.zeros_like(g), lr, "d = 10000",
                                 **kw)
    wall = time.perf_counter() - t0
    log(f"cubic_solve at d = {WIDE_D}, m = 20 ({H.numel() * 4 / 1e9:.2f} GB "
        f"of Hessians): cluster {plan.cluster} CTAs a worker, H "
        f"{plan.mode}; max |Δs| vs plain {err:.3e}, iterations {it.tolist()}"
        f" vs {pit.tolist()}; kernel and plain {wall:.2f} s together")
    del exp, g, H, lr
    torch.cuda.empty_cache()
    return {"shape": [20, WIDE_D], "cluster": plan.cluster,
            "mode": plan.mode, "max_abs_err": err,
            "iterations": int(it.sum())}


def cubic_sweep(g, H, s0, lr, kw, s_ref, it_ref, plans, reps: int,
                rounds: int = 3) -> dict:
    """Device milliseconds of the cubic kernel on these inputs in each of
    ``plans`` ((cluster size, mode) pairs), from the profiler: ``rounds``
    readings a plan, the plans taken in turn each round, each reading the
    mean of ``reps`` calls.  Each plan's answer is held to ``s_ref`` and
    ``it_ref`` (the kernel's in the plan its rules pick) by
    :func:`cubic_close`.  The plans go to the kernel's C entry point, which
    takes the layout :func:`cubic_plan` gives the wrapper."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.cubic_step import MODES

    m, d = g.shape
    s = torch.empty_like(g)
    iters = torch.empty(m, dtype=torch.int32, device=g.device)
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(cluster, mode):
        scratch = (torch.empty((m, 2, d), device=g.device)
                   if mode == "streamed_global_s" else None)

        def run():
            _build.launch("cubic_solve", g.data_ptr(), H.data_ptr(),
                          s0.data_ptr(), lr.data_ptr(), s.data_ptr(),
                          iters.data_ptr(),
                          None if scratch is None else scratch.data_ptr(),
                          m, d, 0.5 * kw["M"] * kw["gamma"] ** 2,
                          kw["gamma"], kw["tol"], kw["max_iters"], cluster,
                          MODES.index(mode), stream)
        return run

    runs = {f"{mode} C={c}": launcher(c, mode) for c, mode in plans}
    out = {name: [] for name in runs}
    for _ in range(rounds):
        for name, run in runs.items():
            out[name].append(kernel_device_ms(run, reps,
                                              "cubic_solve_kernel"))
            cubic_close(s, iters, s_ref, it_ref, lr, kw["tol"],
                        ("cubic plan", d, name))
    return out


def topk_edge_stacks(m: int, d: int, seed: int) -> dict:
    """(m, d) float32 stacks on the card that stress the top-k contract:
    normal rows, rows rounded to halves and small integers (ties), zeros,
    ±0.0 mixed with values, ±inf among values, subnormals only, and rows of
    one magnitude with mixed signs."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand():
        return torch.rand(m, d, generator=gen, device="cuda")

    normal = torch.randn(m, d, generator=gen, device="cuda")
    signs = torch.where(rand() < 0.5, -1.0, 1.0)
    u = rand()
    return {"normal": normal, "halves": torch.round(normal * 2) / 2,
            "ints": torch.randint(-3, 4, (m, d), generator=gen,
                                  device="cuda").float(),
            "zeros": torch.zeros(m, d, device="cuda"),
            "pm_zero": torch.where(rand() < 0.6, 0.0, normal) * signs,
            "pm_inf": torch.where(u < 0.05, float("inf"),
                                  torch.where(u < 0.1, float("-inf"),
                                              normal)),
            "subnormal": normal * 1e-39, "equal": signs * 0.75}


def hold_topk_edges(shapes, counter: str) -> float:
    """``topk_compress`` over :func:`topk_edge_stacks` of each (m, d) at
    k = 1, d / 10 and d: values (their bits) and indices equal to the plain
    version's, and one launch of ``counter`` a call; returns the largest
    |Δ| (0)."""
    import torch

    from repro_torch.kernels import (
        LAUNCHES,
        topk_compress,
        topk_compress_plain,
    )

    err = 0.0
    for m, d in shapes:
        for kind, x in topk_edge_stacks(m, d, m + d).items():
            for k in sorted({1, max(1, d // 10), d}):
                before = LAUNCHES[counter]
                v, i = topk_compress(x, k)
                torch.cuda.synchronize()
                check(LAUNCHES[counter] == before + 1,
                      (counter, "one launch a call", m, d, k, kind))
                pv, pi = topk_compress_plain(x, k)
                check(torch.equal(i, pi) and torch.equal(
                    v.view(torch.int32), pv.view(torch.int32)),
                      (counter, "vs plain", m, d, k, kind))
                err = max(err, float((v - pv).abs().nan_to_num().max()))
            del x
    log(f"{counter} equals its plain version bit for bit over the edge "
        f"stacks at {shapes} (normal, halves, ints, zeros, ±0, ±inf, "
        f"subnormals, one magnitude; k = 1, d / 10, d), one launch a call")
    return err


def check_kernels(exp):
    """Each kernel against its plain version on the card; returns the
    record of each (without launches and times)."""
    import torch

    from repro_torch.kernels import (
        cubic_plan,
        cubic_solve,
        cubic_solve_plain,
        topk_compress,
        topk_compress_plain,
    )

    g, H, lr, cfg = first_round_solver_inputs(exp)
    s0 = torch.zeros_like(g)
    kw = dict(M=cfg.M, gamma=cfg.gamma, tol=cfg.solver_tol,
              max_iters=cfg.solver_iters)
    cubic_err, s, iters, piters = hold_cubic(g, H, s0, lr, "w8a", **kw)
    plan = cubic_plan(*g.shape)
    # H (360 KB a worker) stays in the shared memory of a cluster of CTAs
    check(plan.mode == "resident" and plan.cluster > 1, plan)
    log(f"cubic_solve vs plain: max |Δs| = {cubic_err:.3e} "
        f"(atol {CUBIC_ATOL}), iterations {iters.tolist()} vs "
        f"{piters.tolist()}; cluster {plan.cluster} CTAs a worker, H "
        f"{plan.mode}, {plan.smem_bytes} B of shared memory a CTA")
    # one iteration from a non-zero iterate: cubic_step's contract
    s1, _ = cubic_solve(g, H, s, lr, M=cfg.M, gamma=cfg.gamma, tol=-1.0,
                        max_iters=1)
    p1, _ = cubic_solve_plain(g, H, s, lr, M=cfg.M, gamma=cfg.gamma,
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
    topk_err = max(topk_err, hold_topk_edges(TOPK_EDGE_SINGLE,
                                             "topk_compress"))
    return {"g": g, "H": H, "lr": lr, "cfg": cfg, "s": s, "plan": plan,
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
    :data:`AGG_SHAPES` (the sort also against the CPU's stable sort),
    :data:`AGG_WIDE_SHAPES` and :data:`AGG_LIMIT_SHAPES`, and the w8a
    round's own stack; krum's d2 bitwise symmetric at each.  Returns the
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
    from repro_torch.kernels.robust_agg import _krum_launch

    def bits(t):
        return t.view(torch.int32)

    gen = torch.Generator(device="cuda").manual_seed(1)
    krum_rel, n_argmin = 0.0, 0
    for m, d in AGG_SHAPES + AGG_WIDE_SHAPES + AGG_LIMIT_SHAPES:
        stacks = agg_stacks(m, d, gen)
        for kind, x in stacks.items():
            out = sort_workers(x)
            torch.cuda.synchronize()
            check(torch.equal(bits(out), bits(sort_workers_plain(x))),
                  ("sort_workers vs plain", m, d, kind))
            if (m, d) in AGG_SHAPES:
                check(torch.equal(bits(out.cpu()),
                                  bits(sort_workers_plain(x.cpu()))),
                      ("sort_workers vs the CPU's stable sort", m, d, kind))
        x, n_byz = stacks["normal"], m // 5
        del stacks
        got, d2 = _krum_launch(x, n_byz)
        torch.cuda.synchronize()
        check(torch.equal(bits(d2), bits(d2.T)), ("krum d2 symmetric", m, d))
        want = krum_scores_plain(x, n_byz)
        check(bool(((got - want).abs() <= KRUM_RTOL * want.abs()).all()),
              ("krum_scores vs plain", m, d))
        krum_rel = max(krum_rel, float(((got - want).abs()
                                        / want.abs()).max()))
        if scores_decide(want):
            check(int(torch.argmin(got)) == int(torch.argmin(want)),
                  ("krum argmin", m, d))
            n_argmin += 1
        del x, got, d2, want
        torch.cuda.empty_cache()
    ints = torch.randint(-3, 4, (20, 300), generator=gen,
                         device="cuda").float()
    check(torch.equal(krum_scores(ints, 4), krum_scores_plain(ints, 4)),
          "krum_scores exact on an integer stack")
    shapes = AGG_SHAPES + AGG_WIDE_SHAPES + AGG_LIMIT_SHAPES
    log(f"sort_workers equals its plain version bit for bit over {shapes} "
        f"(normal, ties with ±0, ±inf and NaN), and the CPU's stable sort "
        f"over {AGG_SHAPES}; krum_scores within rtol {KRUM_RTOL} (largest "
        f"{krum_rel:.3e}), d2 bitwise symmetric, exact on integers, argmin "
        f"equal in {n_argmin} shapes")

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
    and rows rounded to halves, ±0 among them); the sparse center bit for
    bit over :data:`SPARSE_AGG_SHAPES` (the solve's top-k payloads, with the
    norm_trim keep as 0/1 weights and without).  Returns the inputs and
    errors for the timings."""
    import torch

    from repro_torch.api import ExperimentSpec
    from repro_torch.core.aggregation import norm_trim_keep
    from repro_torch.kernels import (
        aggregate_sparse,
        aggregate_sparse_plain,
        cubic_plan,
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
    cubic_err, s, iters, piters = hold_cubic(g, H, s0, lr, "d = 5000", **kw)
    plan = cubic_plan(*g.shape)
    # H (100 MB a worker) streams; a worker's rows spread over a cluster
    check(plan.mode == "streamed" and plan.cluster > 1, plan)
    n_iters = int(iters.sum())
    cubic_ms = cuda_ms(lambda: cubic_solve(g, H, s0, lr, **kw), reps=2,
                       warmup=1)
    cubic_plain_ms = cuda_ms(lambda: cubic_solve_plain(g, H, s0, lr, **kw),
                             reps=1, warmup=0)
    cubic_dev = kernel_device_ms(lambda: cubic_solve(g, H, s0, lr, **kw), 2,
                                 "cubic_solve_kernel")
    m, d = g.shape
    cubic_bound, cubic_by = bound_ms(4 * (m * d * d + 4 * m * d + 2 * m),
                                     n_iters * (2 * d * d + 8 * d))
    # the design's own floor: every iteration streams its worker's H
    stream_bytes = 4 * n_iters * d * d
    stream_ms = stream_bytes / PEAK_BYTES_PER_S * 1e3
    sweep = cubic_sweep(g, H, s0, lr, kw, s, iters, CUBIC_SWEEP_GISETTE, 1)
    log(f"cubic_solve at d = 5000, device ms by plan: {json.dumps(sweep)}")
    log(f"cubic_solve at d = 5000 vs plain: max |Δs| = {cubic_err:.3e}, "
        f"iterations {iters.tolist()} vs {piters.tolist()}; cluster "
        f"{plan.cluster} CTAs a worker ({plan.max_active_clusters} such "
        f"clusters fit at once), H {plan.mode}; {cubic_ms:.3f} ms a call, "
        f"{cubic_dev} ms on the device, plain {cubic_plain_ms:.3f} ms; H "
        f"stream {stream_bytes} B = {stream_ms:.3f} ms at 3.35 TB/s "
        f"({stream_bytes / (cubic_dev or cubic_ms) / 1e9:.3f} TB/s achieved)")
    del g, H, lr, s0
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
    topk_err = max(topk_err, hold_topk_edges(TOPK_EDGE_SHARDED,
                                             "topk_sharded"))

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
            out = aggregate_sparse(pv, pi, d, w)
            torch.cuda.synchronize()
            want = aggregate_sparse_plain(pv, pi, d, w)
            check(torch.equal(bits(out), bits(want)),
                  ("sparse_agg vs plain", m, kk, d, dup, w is None))
            agg_err = max(agg_err, float((out - want).abs().max()))
    log(f"aggregate_sparse (the kernel at every d) equals its plain version "
        f"bit for bit over {SPARSE_AGG_SHAPES} (the d = 5000 payloads; 0/1 "
        f"weights and none)")
    return {"s": s, "k": k, "vals": vals, "idx": idx, "keep": keep,
            "topk_err": topk_err, "agg_err": agg_err,
            "cubic": {"shape": [20, GISETTE_D], "iterations": n_iters,
                      "max_abs_err": cubic_err, "ms": cubic_ms,
                      "device_ms": cubic_dev, "plain_ms": cubic_plain_ms,
                      "bound_ms": cubic_bound, "bound_by": cubic_by,
                      "stream_bytes": stream_bytes,
                      "stream_ms_at_hbm": stream_ms,
                      "cluster": plan.cluster, "mode": plan.mode,
                      "max_active_clusters": plan.max_active_clusters,
                      "device_ms_by_plan": sweep}}


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


def check_sparse_spec_against_cpu(spec_kw: dict, rounds: int, label: str,
                                  loss_rtol: float) -> None:
    """A sparse-center spec on the card and on the CPU over the same data,
    ``rounds`` rounds: equal ledger integers, equal keep masks each round,
    loss within ``loss_rtol``."""
    import numpy as np
    import torch

    from repro_torch import interop
    from repro_torch.api import ExperimentSpec

    spec = ExperimentSpec(**spec_kw)
    cpu = spec.build(device="cpu")
    card = spec.build(problem=interop.problem_from_reference(
        cpu.problem, device="cuda"))
    wg, hg = card.run(rounds)
    wc, hc = cpu.run(rounds)
    np.testing.assert_allclose(hg["loss"], hc["loss"], rtol=loss_rtol)
    for key in ("uplink_bits", "downlink_bits", "bits_cumulative"):
        check(hg[key] == hc[key], (label, key))

    def keeps(exp):
        algo, p = exp.algo, exp.problem
        check(algo._use_sparse_center, (label, "sparse center"))
        w, v, st = p.w0, torch.zeros_like(p.w0), algo.init_comm_state()
        out = []
        for _ in range(rounds):
            w, v, st, info = algo.step(w, p.X_workers, p.y_workers, None, v,
                                       st)
            out.append(info["keep"].cpu())
        return out

    for kg, kc in zip(keeps(card), keeps(cpu)):
        check(torch.equal(kg, kc), (label, "keep masks", kg, kc))
    log(f"{label}: card and CPU agree over {rounds} rounds, loss "
        f"{hg['loss']} vs {hc['loss']}, equal ledger integers and keep "
        f"masks")


def w8a_sparse_payloads():
    """One round's payloads of :data:`W8A_SPARSE` on the card: the first
    round's solve through top-k, (20, 30) values and indices, and the
    norm_trim keep as weights."""
    import torch

    from repro_torch.api import ExperimentSpec
    from repro_torch.core.aggregation import norm_trim_keep
    from repro_torch.kernels import cubic_solve, topk_compress

    exp = ExperimentSpec(**W8A_SPARSE).build()
    exp.algo._ensure_channels(exp.problem.dim, exp.problem.m_workers)
    g, H, lr, cfg = first_round_solver_inputs(exp)
    s, _ = cubic_solve(g, H, None, lr, M=cfg.M, gamma=cfg.gamma,
                       tol=cfg.solver_tol, max_iters=cfg.solver_iters)
    vals, idx = topk_compress(s, exp.algo.uplink.compressor.k)
    keep, _ = norm_trim_keep(torch.linalg.vector_norm(vals, dim=1),
                             exp.algo.aggregator.beta)
    return vals, idx, keep, exp.problem.dim


def check_f1(vals, idx, keep, d: int) -> dict:
    """F1, the sparse center's determinism at w8a's width, over one round's
    payloads: ``index_add_`` on the card (:data:`F1_INDEX_ADD_RUNS` runs)
    against itself and against the CPU's plain version, bit for bit, for the
    record; then ``aggregate_sparse`` on the card twice and on the CPU,
    which must agree bit for bit, one kernel launch a call; then
    :data:`W8A_SPARSE` on the card against the CPU for 3 rounds."""
    import torch

    from repro_torch.kernels import (
        LAUNCHES,
        aggregate_sparse,
        aggregate_sparse_plain,
    )

    def bits(t):
        return t.view(torch.int32).cpu()

    cpu = aggregate_sparse_plain(vals.cpu(), idx.cpu(), d, keep.cpu())
    flat_i = idx.reshape(-1).long()
    flat_v = (vals * keep[:, None]).reshape(-1)
    runs = [bits(torch.zeros(d, device="cuda").index_add_(0, flat_i, flat_v))
            for _ in range(F1_INDEX_ADD_RUNS)]
    distinct = len({tuple(r.tolist()) for r in runs})
    off_cpu = [int((r != bits(cpu)).sum()) for r in runs]
    shared = int((torch.bincount(flat_i, minlength=d) > 1).sum())
    found = (f"index_add_ on the card, {F1_INDEX_ADD_RUNS} runs over the "
             f"same payloads ({shared} of {d} coordinates summed from more "
             f"than one entry): {distinct} distinct results; coordinates "
             f"whose bits differ from the CPU's stream-order sum, by run: "
             f"{off_cpu}")

    before = LAUNCHES["sparse_agg"]
    card = [aggregate_sparse(vals, idx, d, keep) for _ in range(2)]
    check(LAUNCHES["sparse_agg"] == before + 2, "one sparse_agg launch a call")
    on_cpu = aggregate_sparse(vals.cpu(), idx.cpu(), d, keep.cpu())
    for out in (*card, on_cpu):
        check(torch.equal(bits(out), bits(cpu)),
              "the sparse center's bits, card and CPU")
    log(f"F1 at w8a's width ({tuple(vals.shape)} payloads over d = {d}, "
        f"norm_trim keep as weights): {found}. aggregate_sparse: two card "
        f"runs (the kernel) and the CPU (index_add_ in stream order) equal "
        f"bit for bit")
    check_sparse_spec_against_cpu(W8A_SPARSE, 3, "F1, w8a sparse center",
                                  1e-4)
    return {"index_add_runs": F1_INDEX_ADD_RUNS,
            "index_add_distinct": distinct, "index_add_off_cpu": off_cpu,
            "shared_coordinates": shared}


def profiled(fn):
    """One call of ``fn`` under ``torch.profiler``, after a synchronise:
    its host-clock milliseconds (ending in a synchronise), the device's busy
    milliseconds, and (device ms, count, name) of each device event name,
    the largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_PAD_S)
    rows = sorted(((getattr(e, "device_time_total",
                            getattr(e, "cuda_time_total", 0.0)) / 1e3,
                    e.count, e.key[:90]) for e in prof.key_averages()),
                  reverse=True)
    return wall_ms, sum(r[0] for r in rows), rows


def round_breakdown(spec_kw: dict = W8A, phases: bool = True,
                    label: str = "w8a") -> None:
    """Profile one round (``step``) of ``spec_kw`` on the card: the
    host-clock time, the device's busy time and share, the kernels by
    device time and the wire's and the center's kernels among them; then,
    with ``phases``, time the round's phases alone, with the peak memory of
    each."""
    import torch
    from torch.func import grad

    from repro_torch.api import ExperimentSpec
    from repro_torch.core import solve_cubic_gd

    exp = ExperimentSpec(**spec_kw).build()
    p, algo = exp.problem, exp.algo
    cfg = algo.config
    gen = torch.Generator(device="cuda").manual_seed(0)
    w, v, st, _ = algo.step(p.w0, p.X_workers, p.y_workers, gen)  # warm-up
    wall_ms, busy_ms, rows = profiled(
        lambda: algo.step(w, p.X_workers, p.y_workers, gen, v, st))
    top = "; ".join(f"{name} x{n}: {ms:.4f} ms" for ms, n, name in rows[:8])
    ours = ("krum_scores", "sort_workers", "sparse_agg", "topk_warp_kernel",
            "topk_cluster_kernel")
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
    cubic_by_plan = cubic_sweep(g, H, s0, lr, kw, s, iters, CUBIC_SWEEP_W8A,
                                20)
    topk_dev = kernel_device_ms(lambda: topk_compress(s, k), 200,
                                "topk_warp_kernel")
    topk_lib_dev = library_device_ms(lambda: torch.topk(s.abs(), k, dim=1),
                                     200)
    log(f"device time per launch (profiler): cubic_solve {cubic_dev} ms, "
        f"topk_compress {topk_dev} ms")
    center = inp["center"]
    cm, cd = center.shape
    w8a_center = time_center(center, 4, 200, 200)
    krum, sort = w8a_center["krum"], w8a_center["sort"]
    # the larger stacks, for how the two designs scale
    scaling = {}
    gen = torch.Generator(device="cuda").manual_seed(3)
    for sm, sd in AGG_TIMED_SHAPES:
        x = torch.randn(sm, sd, generator=gen, device="cuda")
        big = sm * sd > 10**7
        scaling[f"{sm}x{sd}"] = time_center(x, sm // 5, 20 if big else 200,
                                            2 if big else 20)
        del x
        torch.cuda.empty_cache()
    log(f"center kernels at larger stacks (ms): {json.dumps(scaling)}")
    log(f"center kernels on the w8a stack {tuple(center.shape)}: "
        f"{json.dumps(w8a_center)}")
    log(f"cubic_solve {cubic_ms:.4f} ms ({n_iters} iterations over {m} "
        f"workers), plain {cubic_plain_ms:.4f} ms, bound {cubic_bound:.6f} "
        f"ms, H stream {stream_bytes} B = {stream_ms_at_hbm:.6f} ms at the "
        f"HBM rate; topk {topk_ms:.4f} ms, plain {topk_plain_ms:.4f} ms, "
        f"torch.topk {topk_lib_ms:.4f} ms ({topk_lib_dev} ms device), "
        f"bound {topk_bound:.6f} ms")
    return [
        {"name": "cubic_solve", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/cubic_solve.cu",
         "replaces": "src/repro/kernels/cubic_step.py:48",
         "launches": launches["cubic_solve"],
         "max_abs_err": inp["cubic_err"], "ms": cubic_ms,
         "plain_ms": cubic_plain_ms, "bound_ms": cubic_bound,
         "bound_by": cubic_by, "library_ms": None,
         "device_ms": cubic_dev, "iterations": n_iters, "shape": [m, d],
         "cluster": inp["plan"].cluster, "mode": inp["plan"].mode,
         "device_ms_by_plan": cubic_by_plan, "stream_bytes": stream_bytes,
         "stream_ms_at_hbm": stream_ms_at_hbm},
        {"name": "topk_compress", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/topk_compress.cu",
         "replaces": "src/repro/kernels/topk_compress.py:191",
         "launches": launches["topk_compress"],
         "max_abs_err": inp["topk_err"], "ms": topk_ms,
         "plain_ms": topk_plain_ms, "bound_ms": topk_bound,
         "bound_by": topk_by, "library_ms": topk_lib_ms,
         "library_device_ms": topk_lib_dev,
         "device_ms": topk_dev, "shape": [m, d], "k": k,
         "plan": topk_plan_record(m, d)},
        {"name": "krum_scores", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/krum_scores.cu",
         "replaces": "src/repro/kernels/robust_agg.py:358",
         "launches": launches["krum_scores"],
         "max_abs_err": inp["krum_err"], "ms": krum["ms"],
         "plain_ms": krum["plain_ms"], "bound_ms": krum["bound_ms"],
         "bound_by": krum["bound_by"], "library_ms": None,
         "device_ms": krum["device_ms"], "plan": krum["plan"],
         "shape": [cm, cd], "n_byz": 4,
         "max_rel_err_over_shapes": inp["krum_rel"],
         "at_larger_shapes": {key: rec["krum"]
                              for key, rec in scaling.items()}},
        {"name": "sort_workers", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sort_workers.cu",
         "replaces": "src/repro/kernels/robust_agg.py:408",
         "launches": launches["sort_workers"],
         "max_abs_err": inp["sort_err"], "ms": sort["ms"],
         "plain_ms": sort["plain_ms"], "bound_ms": sort["bound_ms"],
         "bound_by": sort["bound_by"], "library_ms": sort["library_ms"],
         "library_device_ms": sort["library_device_ms"],
         "device_ms": sort["device_ms"], "plan": sort["plan"],
         "shape": [cm, cd],
         "at_larger_shapes": {key: rec["sort"]
                              for key, rec in scaling.items()}},
    ]


def time_center(x, n_byz: int, reps: int, plain_reps: int) -> dict:
    """Krum's scores and the worker sort on one (m, d) stack: each kernel
    call (CUDA events, ``ms``), its device time (profiler, both of krum's
    launches), the plain version's call, the bound from this stack's
    least work, the launch plan; for the sort also ``torch.sort(x,
    dim=0)``'s call and device time."""
    import torch

    from repro_torch.kernels import (
        krum_plan,
        krum_scores,
        krum_scores_plain,
        sort_plan,
        sort_workers,
        sort_workers_plain,
    )

    m, d = x.shape
    kp, sp = krum_plan(m, d), sort_plan(m, d)
    # each input read once, the scores written once; 3 operations
    # (difference, square, add) per coordinate of each of the m(m-1)/2
    # unordered pairs
    k_bound, k_by = bound_ms(4 * m * d + 4 * m, 3 * m * (m - 1) // 2 * d)
    # the stack read and written once; a comparison sort's least work,
    # ⌈log₂ m⌉ compares per value
    s_bound, s_by = bound_ms(8 * m * d,
                             m * d * math.ceil(math.log2(max(m, 2))))
    krum = {
        "ms": cuda_ms(lambda: krum_scores(x, n_byz), reps=reps),
        "device_ms": kernel_device_ms(lambda: krum_scores(x, n_byz), reps,
                                      "krum_scores_kernel"),
        "plain_ms": cuda_ms(lambda: krum_scores_plain(x, n_byz),
                            reps=plain_reps, warmup=1),
        "bound_ms": k_bound, "bound_by": k_by,
        "plan": {"tile": kp.tile, "tiles": kp.tiles, "slices": kp.slices,
                 "fused": kp.fused}}
    sort = {
        "ms": cuda_ms(lambda: sort_workers(x), reps=reps),
        "device_ms": kernel_device_ms(lambda: sort_workers(x), reps,
                                      "sort_workers_kernel"),
        "plain_ms": cuda_ms(lambda: sort_workers_plain(x), reps=plain_reps,
                            warmup=1),
        "library_ms": cuda_ms(lambda: torch.sort(x, dim=0), reps=reps),
        "library_device_ms": library_device_ms(lambda: torch.sort(x, dim=0),
                                               reps),
        "bound_ms": s_bound, "bound_by": s_by,
        "plan": {"tile": sp.tile, "pad": sp.pad, "per_thread": sp.per_thread,
                 "lanes": sp.lanes, "threads": sp.threads}}
    return {"krum": krum, "sort": sort}


def topk_plan_record(m: int, d: int) -> dict:
    """The launch ``topk_compress`` makes for an (m, d) stack, as JSON; for
    the cluster kernel with the coordinates a CTA keeps in shared memory
    and its shared memory, as the source lays them out on this card."""
    import dataclasses

    from repro_torch.kernels import topk_plan
    from repro_torch.kernels.topk_compress import sharded_layout

    plan = topk_plan(m, d)
    rec = {**dataclasses.asdict(plan), "threads": plan.threads,
           "ctas": plan.ctas}
    if plan.route == "sharded":
        _, rec["keep"], rec["smem_bytes"] = sharded_layout(d, plan.cluster)
    return rec


def topk_launcher(x, k: int, cluster: int):
    """A call of the cluster kernel on x through its C entry, at another
    cluster size than the plan's."""
    import torch

    from repro_torch.kernels import _build

    m, d = x.shape

    def run():
        vals = torch.empty(m, k, device=x.device)
        idx = torch.empty(m, k, dtype=torch.int32, device=x.device)
        _build.launch("topk_sharded", x.data_ptr(), vals.data_ptr(),
                      idx.data_ptr(), m, d, k, cluster,
                      torch.cuda.current_stream().cuda_stream)
        return vals, idx
    return run


def topk_sweep(x, k: int) -> dict:
    """Kernel device ms of the cluster kernel at x's shape at every cluster
    size (each keeping what its slice may in shared memory), each held
    against the plain version first; ``{}`` at the single tile's widths,
    whose launch has no parameter."""
    import torch

    from repro_torch.kernels import kernel_plan, topk_compress_plain
    from repro_torch.kernels.topk_compress import TOPK_CLUSTER_SIZES

    m, d = x.shape
    if kernel_plan(d) == "single_tile":
        return {}
    pv, pi = topk_compress_plain(x, k)
    out = {}
    for c in TOPK_CLUSTER_SIZES:
        label, run = f"c{c}", topk_launcher(x, k, c)
        v, i = run()
        check(torch.equal(i, pi) and torch.equal(v.view(torch.int32),
                                                 pv.view(torch.int32)),
              ("top-k sweep vs plain", m, d, k, label))
        out[label] = kernel_device_ms(run, 30, "topk_cluster_kernel")
    return out


def time_topk() -> dict:
    """The top-k calls of :data:`TOPK_TIMED` on normal rows: CUDA-event ms
    a call (``ms``, host launch overhead included), the profiler's device
    span of a call from its first kernel's start to its last one's end
    (``device_span_ms``) and its kernels' own time (``device_ms``), the
    device events a call runs (one: the kernel), ``torch.topk`` of |x|
    (``library_ms``; ``library_device_ms`` its kernels, ``library_span_ms``
    its span), the plain version, the bound (x read once and the payload
    written once at 3.35 TB/s; the select's compares at 67 TFLOP/s), the
    plan, and the cluster kernel at other cluster sizes
    (:func:`topk_sweep`)."""
    import torch

    from repro_torch.kernels import (
        LAUNCHES,
        kernel_plan,
        topk_compress,
        topk_compress_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for m, d, k in TOPK_TIMED:
        x = torch.randn(m, d, generator=gen, device="cuda")
        name = ("topk_compress" if kernel_plan(d) == "single_tile"
                else "topk_sharded")

        def call():
            return topk_compress(x, k)

        def lib():
            return torch.topk(x.abs(), k, dim=1)

        before = LAUNCHES[name]
        call()
        check(LAUNCHES[name] == before + 1, (name, "one launch a call", m, d))
        span = device_span_ms(call, 30)
        check(span["events"] == 1, (name, "one device event a call", m, d,
                                    span))
        lib_span = device_span_ms(lib, 30)
        bound, by = bound_ms(4 * m * d + 8 * m * k,
                             (32 if name == "topk_compress" else 5) * m * d)
        out[f"{m}x{d}"] = {
            "name": name, "shape": [m, d], "k": k,
            "ms": cuda_ms(call, 200), "device_span_ms": span["span_ms"],
            "device_ms": span["kernel_ms"], "events": span["events"],
            "plain_ms": cuda_ms(lambda: topk_compress_plain(x, k), 20),
            "library_ms": cuda_ms(lib, 200),
            "library_device_ms": library_device_ms(lib, 100),
            "library_span_ms": lib_span["span_ms"],
            "bound_ms": bound, "bound_by": by,
            "plan": topk_plan_record(m, d),
            "device_ms_by_plan": topk_sweep(x, k)}
        del x
        torch.cuda.empty_cache()
    log(f"top-k calls timed (ms): {json.dumps(out)}")
    return out


def time_sparse_center(vals, idx, keep, d: int, reps: int = 200) -> dict:
    """The sparse center's kernel over one round's payloads, summed with
    the norm_trim keep as weights: its call (events), its device time
    (profiler), the plain version's call, and ``index_add_``'s call and
    device time (the fill of its zeros and the scatter) on the same
    weighted values, with the bound."""
    import torch

    from repro_torch.kernels import aggregate_sparse, aggregate_sparse_plain

    m, k = vals.shape
    lib_idx = idx.reshape(-1).long()
    lib_vals = (vals * keep[:, None]).reshape(-1)

    def lib():
        return torch.zeros(d, device=vals.device).index_add_(0, lib_idx,
                                                             lib_vals)

    dev = device_ms_by_name(lambda: aggregate_sparse(vals, idx, d, keep),
                            reps, ("sparse_agg_kernel",))
    # the payloads and weights read once, the aggregate written once; a
    # multiply and an add per payload entry
    bound, by = bound_ms(8 * m * k + 4 * m + 4 * d, 2 * m * k)
    return {"shape": [m, k], "d": d,
            "ms": cuda_ms(lambda: aggregate_sparse(vals, idx, d, keep), reps),
            "device_ms": dev["sparse_agg_kernel"], "device_ms_call": dev["all"],
            "plain_ms": cuda_ms(lambda: aggregate_sparse_plain(vals, idx, d,
                                                               keep), 50),
            "library_ms": cuda_ms(lib, reps),
            "library_device_ms": library_device_ms(lib, reps),
            "bound_ms": bound, "bound_by": by}


def time_gisette_kernels(inp: dict, launches: dict, w8a_payload) -> list:
    """The records of the sharded top-k and the sparse center at drive A's
    shapes: the (20, 5000) updates at k = 500, and their (20, 500) payloads
    summed with the norm_trim keep as weights; the sparse center also at
    w8a's (20, 30) payloads over d = 300."""
    import torch

    from repro_torch.kernels import topk_compress_plain, topk_compress_sharded

    s, k, vals, idx, keep = (inp[n] for n in ("s", "k", "vals", "idx",
                                                "keep"))
    m, d = s.shape
    topk_ms = cuda_ms(lambda: topk_compress_sharded(s, k), reps=200)
    topk_plain_ms = cuda_ms(lambda: topk_compress_plain(s, k), reps=50)
    topk_lib_ms = cuda_ms(lambda: torch.topk(s.abs(), k, dim=1), reps=200)
    topk_dev = kernel_device_ms(lambda: topk_compress_sharded(s, k), 200,
                                "topk_cluster_kernel")
    topk_lib_dev = library_device_ms(lambda: torch.topk(s.abs(), k, dim=1),
                                     200)
    # x read once and the payload written once; per coordinate three
    # histogram updates and the sure/tie compares
    topk_bound, topk_by = bound_ms(4 * m * d + 8 * m * k, 5 * m * d)
    agg = time_sparse_center(vals, idx, keep, d)
    agg_w8a = time_sparse_center(*w8a_payload)
    log(f"topk_compress_sharded at ({m}, {d}), k = {k}: {topk_ms:.4f} ms a "
        f"call, {topk_dev} ms on the device, plain {topk_plain_ms:.4f} ms, "
        f"torch.topk {topk_lib_ms:.4f} ms ({topk_lib_dev} ms device), "
        f"bound {topk_bound:.7f} ms; "
        f"the sparse center (ms; drive A, then w8a): {json.dumps(agg)}; "
        f"{json.dumps(agg_w8a)}")
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
         "library_device_ms": topk_lib_dev,
         "device_ms": topk_dev, "shape": [m, d], "k": k,
         "plan": topk_plan_record(m, d)},
        {"name": "sparse_agg", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sparse_agg.cu",
         "replaces": "src/repro/kernels/robust_agg.py:245",
         "launches": launches["sparse_agg"],
         "max_abs_err": inp["agg_err"], **agg, "at_w8a": agg_w8a},
    ]


def close_to_plain(got, want, what: str) -> float:
    """Hold a model kernel's output against its plain version's at
    :data:`F32_TOL` (float32) or :data:`BF16_RTOL`/:data:`BF16_ATOL`
    (bf16); return the largest absolute difference."""
    import torch

    check(got.dtype == want.dtype and got.shape == want.shape,
          (what, got.dtype, want.dtype, tuple(got.shape), tuple(want.shape)))
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), (what, "finite"))
    rtol, atol = ((BF16_RTOL, BF16_ATOL) if want.dtype == torch.bfloat16
                  else (F32_TOL, F32_TOL))
    diff = (g - w).abs()
    check(bool((diff <= atol + rtol * w.abs()).all()),
          (what, float(diff.max())))
    return float(diff.max())


def flash_inputs(S: int, dtype, seed: int, heads=FLASH_HEADS,
                 q_scale: float = 1.0):
    """q (1, S, H, Dh) and k, v (1, S, Hkv, Dh) for ``heads`` = (H, Hkv,
    Dh), by default (32, 16, 128): gemma3-27b's attention at a (1, S)
    prefill; q scaled by ``q_scale``."""
    import torch

    H, Hkv, Dh = heads
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(1, S, h, Dh, generator=gen, device="cuda")
               for h in (H, Hkv, Hkv))
    return (q * q_scale).to(dtype), k.to(dtype), v.to(dtype)


def check_model_kernels() -> dict:
    """RMSNorm and flash attention against their plain versions on the card
    at the model's shapes (:data:`RMS_SHAPES`, :data:`FLASH_CASES`,
    :data:`FLASH_WIDE_HEADS`, :data:`FLASH_Q_SCALES`); returns their
    largest errors."""
    import torch

    from repro_torch.kernels import (
        attention_bshd,
        attention_plain,
        rmsnorm,
        rmsnorm_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(5)
    rms_err = 0.0
    for n, d in RMS_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = (3 * torch.randn(n, d, generator=gen, device="cuda")).to(dtype)
            w = (0.1 * torch.randn(d, generator=gen, device="cuda")).to(dtype)
            rms_err = max(rms_err, close_to_plain(
                rmsnorm(x, w), rmsnorm_plain(x, w), ("rmsnorm", n, d, dtype)))
    log(f"rmsnorm within its tolerance of the plain version at {RMS_SHAPES}, "
        f"bf16 and float32 (largest |Δ| {rms_err:.3e})")

    def hold_flash(S, window, dtype, seed, **kw):
        q, k, v = flash_inputs(S, dtype, seed, **kw)
        got = attention_bshd(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        want = attention_plain(q, k, v, causal=True, window=window)
        return close_to_plain(got, want, ("flash_attention", S, window,
                                          dtype, kw))

    flash_err = 0.0
    for i, (S, window) in enumerate(FLASH_CASES):
        dtypes = ((torch.bfloat16,) if S == PREFILL_LEN
                  else (torch.bfloat16, torch.float32))
        for dtype in dtypes:
            flash_err = max(flash_err, hold_flash(S, window, dtype, 10 + i))
    log(f"flash_attention within its tolerance of the plain version at "
        f"(1, S, 32/16, 128), (S, window) in {FLASH_CASES}, bf16 (and "
        f"float32 at S = 4000) (largest |Δ| {flash_err:.3e})")
    wide_err = max(
        hold_flash(S, FLASH_WIDE_WINDOW, dtype, 30, heads=FLASH_WIDE_HEADS)
        for S, dtype in ((PREFILL_LEN, torch.bfloat16),
                         (4000, torch.float32)))
    log(f"flash_attention at recurrentgemma-9b's heads {FLASH_WIDE_HEADS}, "
        f"window {FLASH_WIDE_WINDOW}, bf16 at S = {PREFILL_LEN} and float32 "
        f"at S = 4000: within its tolerance (largest |Δ| {wide_err:.3e})")
    split_err = {scale: hold_flash(PREFILL_LEN, 0, torch.bfloat16, 40,
                                   q_scale=scale)
                 for scale in FLASH_Q_SCALES}
    log(f"flash_attention bf16 with q scaled by {FLASH_Q_SCALES} (flat and "
        f"peaked softmax) at (1, {PREFILL_LEN}, 32/16, 128): within its "
        f"tolerance (largest |Δ| by scale {split_err})")
    return {"rms_err": rms_err,
            "flash_err": max(flash_err, wide_err, *split_err.values()),
            "flash_wide_err": wide_err, "flash_split_err": split_err,
            "hgmma": hgmma_count()}


def hgmma_count() -> int:
    """The ``HGMMA`` (wgmma) instructions in the built flash attention
    library, by ``cuobjdump -sass``: the bf16 route runs on the tensor
    cores only if there are some."""
    from repro_torch.kernels import _build

    lib = _build.build_all()["flash_attention"]
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    n = sum("HGMMA" in line for line in sass.splitlines())
    log(f"{lib.name}: {n} HGMMA instructions in its SASS")
    check(n > 0, ("no HGMMA in the flash attention library", lib.name))
    return n


def check_small_model_against_cpu() -> None:
    """A reduced gemma3 (6 layers, window 16, float32) with grouped kv heads
    on the card (the kernels) and on the CPU (the plain versions), over the
    same weights: the forward of a (2, 100) prompt (S no multiple of the
    kernel's tile, past the window) within 1e-4, and 20 greedy tokens
    after a 24-token prompt equal, their logits within 1e-4."""
    import copy
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("gemma3-27b").reduced(),
                              num_kv_heads=SMALL_MODEL_KV_HEADS)
    cpu = build_model(cfg, device="cpu")
    card = build_model(cfg, device="cuda")
    p_cpu = cpu.init(3)
    p_card = copy.deepcopy(p_cpu).to("cuda")
    toks, _ = TokenStream(cfg.vocab_size, 3, device="cpu").batch(0, 2, 100)
    lg_card, _ = card.forward(p_card, toks.cuda())
    lg_cpu, _ = cpu.forward(p_cpu, toks)
    fwd_err = float((lg_card.cpu() - lg_cpu).abs().max())
    check(fwd_err <= 1e-4, ("reduced forward, card vs CPU", fwd_err))
    out_card = greedy_generate(card, p_card, toks[:, :24].cuda(), 20)
    out_cpu = greedy_generate(cpu, p_cpu, toks[:, :24], 20)
    check(torch.equal(out_card["tokens"].cpu(), out_cpu["tokens"]),
          "reduced greedy tokens, card vs CPU")
    dec_err = float((out_card["logits"].cpu() - out_cpu["logits"]).abs().max())
    check(dec_err <= 1e-4, ("reduced decode logits, card vs CPU", dec_err))
    log(f"reduced gemma3 (kv heads {SMALL_MODEL_KV_HEADS}): card and CPU "
        f"agree, forward max |Δ| {fwd_err:.3e}, 20 greedy tokens equal, "
        f"decode logits max |Δ| {dec_err:.3e}")


def serve_full_width() -> dict:
    """Serve gemma3-27b at full width through ``run_serving`` (the user's
    entry point): counts set to 0 just before, read just after; one RMSNorm
    launch per norm of every decode step, no other kernel."""
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import run_serving

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = run_serving(**SERVE)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    steps = SERVE["prompt_len"] + SERVE["gen"]
    check(res["device"].type == "cuda", res["device"])
    check(res["param_count"] == GEMMA_PARAMS, res["param_count"])
    check(res["wire"]["downlink_bits"] == 32 * GEMMA_PARAMS, res["wire"])
    toks = res["tokens"]
    check(tuple(toks.shape) == (SERVE["batch"], SERVE["gen"])
          and bool(((toks >= 0) & (toks < res["cfg"].padded_vocab)).all()),
          ("served tokens", tuple(toks.shape)))
    check(launches == {name: NORMS_PER_PASS * steps if name == "rmsnorm"
                       else 0 for name in launches}, launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"served {res['cfg'].name} at full width ({res['param_count']} "
        f"parameters, bf16): broadcast {res['wire']['downlink_bits']} bits; "
        f"prefill {SERVE['prompt_len']} tokens {res['prefill_s']:.3f} s, "
        f"decode {SERVE['gen']} tokens {res['decode_s']:.3f} s "
        f"({res['tok_per_s']:.1f} tok/s), step p50 "
        f"{res['p50_s'] * 1e3:.3f} ms p99 {res['p99_s'] * 1e3:.3f} ms; "
        f"{wall:.1f} s in all with the weights' init, peak {peak:.1f} GiB; "
        f"launches {launches} ({NORMS_PER_PASS} RMSNorm a step)")
    return {"launches": launches, "res": res}


@contextlib.contextmanager
def plain_versions(held=None):
    """Run the models' norms and attention through the kernels' plain
    versions (on the card) while the block lives: the comparison path.
    With a list ``held``, each plain call also runs its kernel on the same
    inputs, holds the two by :func:`close_to_plain` and appends
    ``(name, largest |Δ|, relative Frobenius error)`` to ``held``."""
    from unittest import mock

    import torch

    from repro_torch.kernels import (
        attention_bshd,
        attention_plain,
        rmsnorm_nd,
        rmsnorm_plain,
    )
    from repro_torch.models import attention, layers

    def hold(name, kernel, plain_out):
        if held is not None:
            got = kernel()
            w = plain_out.float()
            held.append((name, close_to_plain(got, plain_out, name),
                         float(torch.linalg.vector_norm(got.float() - w)
                               / torch.linalg.vector_norm(w))))
        return plain_out

    def plain_norm(x, w, eps=1e-6):
        return hold("rmsnorm", lambda: rmsnorm_nd(x, w, eps=eps),
                    rmsnorm_plain(x, w, eps))

    def plain_attention(q, k, v, *, causal=True, window=None, **_):
        return hold("flash_attention",
                    lambda: attention_bshd(q, k, v, causal=causal,
                                           window=window or 0),
                    attention_plain(q, k, v, causal=causal,
                                    window=window or 0))

    with mock.patch.object(layers, "rms_norm", plain_norm), \
            mock.patch.object(attention, "chunked_attention", plain_attention):
        yield


def compare(a, b, rows: int = 512) -> dict:
    """``a`` against ``b`` over their last axis, a slab of rows at a time in
    float32 (the logits are 2 GiB in bf16): ‖a − b‖ / ‖b‖ (``rel``), the
    largest |a − b| and the share of rows whose argmax agree."""
    import torch

    a2, b2 = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    diff2 = ref2 = 0.0
    max_abs, agree = 0.0, 0
    for i in range(0, a2.shape[0], rows):
        x, y = a2[i:i + rows].float(), b2[i:i + rows].float()
        diff2 += float(torch.sum((x - y).double() ** 2))
        ref2 += float(torch.sum(y.double() ** 2))
        max_abs = max(max_abs, float((x - y).abs().max()))
        agree += int((x.argmax(-1) == y.argmax(-1)).sum())
    return {"rel": math.sqrt(diff2 / ref2), "max_abs": max_abs,
            "argmax_agree": agree / a2.shape[0]}


def prefill_full_width() -> dict:
    """``Model.forward`` of gemma3-27b at full width on a (1, 4096) prompt:
    counts set to 0 just before, read just after (62 flash attention and 125
    RMSNorm launches).  Then, over the same weights: every block through the
    kernels against the same block through the plain versions on the plain
    path's input (:data:`BLOCK_REL_TOL`), and each of its norms and its
    attention through the kernel on the plain calls' inputs
    (:func:`close_to_plain`); the whole forward through the
    plain versions (no launch), and the kernel forward's logits held against
    it within the spread the plain forward itself shows when its
    embeddings move by one bf16 ulp."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import build_model

    cfg = get_config(SERVE["arch"])
    model = build_model(cfg)
    params = model.init(1)
    toks, _ = TokenStream(cfg.vocab_size, 1).batch(0, 1, PREFILL_LEN)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    logits, _ = model.forward(params, toks)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    check(launches == {name: {"flash_attention": GEMMA_LAYERS,
                              "rmsnorm": NORMS_PER_PASS}.get(name, 0)
                       for name in launches}, launches)
    check(tuple(logits.shape) == (1, PREFILL_LEN, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()), "finite prefill logits")
    t0 = time.perf_counter()
    for _ in range(2):
        model.forward(params, toks)
    torch.cuda.synchronize()
    kernel_s = (time.perf_counter() - t0) / 2

    # each block on the plain path's input: its output, and each of its two
    # norms and its attention through the kernel on the plain call's inputs
    x = params.embed[toks]
    pos = torch.arange(PREFILL_LEN, device="cuda").expand(1, PREFILL_LEN)
    block_errs, parts = [], []
    for block in params.layers:
        y_kernel = block.apply(x, cfg, pos)
        with plain_versions(held=parts):
            x = block.apply(x, cfg, pos)
        block_errs.append(compare(y_kernel, x)["rel"])
    del y_kernel, x
    check([name for name, _, _ in parts]
          == ["rmsnorm", "flash_attention", "rmsnorm"] * GEMMA_LAYERS,
          "each block's norms and attention held")
    part_errs = {name: (max(e for n, e, _ in parts if n == name),
                        max(r for n, _, r in parts if n == name))
                 for name in ("rmsnorm", "flash_attention")}

    reset_launches()
    with plain_versions():
        t0 = time.perf_counter()
        plain, _ = model.forward(params, toks)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        check(not any(LAUNCHES.values()), ("plain forward launched",
                                           LAUNCHES))
        # the plain forward's own spread: its embeddings moved by one bf16
        # ulp (towards +inf) in a random half of the prompt's entries
        rows = torch.unique(toks)
        saved = params.embed.data[rows].clone()
        gen = torch.Generator(device="cuda").manual_seed(9)
        up = torch.nextafter(saved, torch.full_like(saved, math.inf))
        params.embed.data[rows] = torch.where(
            torch.rand(saved.shape, generator=gen, device="cuda") < 0.5,
            up, saved)
        nudged, _ = model.forward(params, toks)
        params.embed.data[rows] = saved
        del saved, up
    got, spread = compare(logits, plain), compare(nudged, plain)
    rel, floor = got["rel"], spread["rel"]
    log(f"prefill forward (1, {PREFILL_LEN}) at full width: first "
        f"{first_s:.3f} s, then {kernel_s:.3f} s a forward (the plain "
        f"versions' {plain_s:.3f} s); peak +{peak:.2f} GiB over the weights; "
        f"launches {launches}; each block through the kernels vs the plain "
        f"versions on one input: relative {min(block_errs):.3e} to "
        f"{max(block_errs):.3e} (tolerance {BLOCK_REL_TOL:.3e}); each "
        f"block's norms and attention through the kernel on the plain "
        f"calls' inputs, within rtol {BF16_RTOL:.3e} and atol "
        f"{BF16_ATOL:.0e} (largest |Δ|, largest relative): "
        f"{ {n: (f'{a:.3e}', f'{r:.3e}') for n, (a, r) in part_errs.items()} }"
        f"; logits vs "
        f"the plain forward: relative {rel:.3e}, max |Δ| "
        f"{got['max_abs']:.3e}, argmax equal at "
        f"{100 * got['argmax_agree']:.2f} % of positions; the plain forward "
        f"with its embeddings nudged by one bf16 ulp: relative {floor:.3e}, "
        f"max |Δ| {spread['max_abs']:.3e}, argmax equal at "
        f"{100 * spread['argmax_agree']:.2f} %")
    check(max(block_errs) <= BLOCK_REL_TOL, ("block vs plain", block_errs))
    check(rel <= floor, ("prefill logits vs plain", rel, floor))
    del logits, plain, nudged
    model_breakdown(model, params, toks)
    del params
    torch.cuda.empty_cache()
    return {"launches": launches, "forward_s": kernel_s, "plain_s": plain_s,
            "rel": rel, "floor": floor, "peak_gib": peak,
            "block_errs": block_errs, "part_errs": part_errs}


def model_breakdown(model, params, toks) -> None:
    """Profile one (1, 4096) forward and one decode step of batch 4 at
    position 63 of a 64-token cache (the serving run's last): host-clock
    time, device busy time and share, the kernels by device time."""
    import torch

    cache = model.init_cache(SERVE["batch"], 64)
    tok = toks[0, :SERVE["batch"]]
    for t in range(3):   # warm-up
        model.decode_step(params, cache, tok, t)
    for label, fn in (
            ("forward (1, 4096)", lambda: model.forward(params, toks)),
            ("decode step (batch 4)",
             lambda: model.decode_step(params, cache, tok, 63))):
        wall_ms, busy_ms, rows = profiled(fn)
        ours = {name: (ms, n) for ms, n, name in rows
                if "rmsnorm_kernel" in name or "flash_kernel" in name}
        top = "; ".join(f"{name} x{n}: {ms:.3f} ms"
                        for ms, n, name in rows[:10])
        log(f"gemma3-27b {label}, profiled: {wall_ms:.3f} ms on the host "
            f"clock, device busy {busy_ms:.3f} ms "
            f"({100 * busy_ms / wall_ms:.1f} %) in "
            f"{sum(n for ms, n, _ in rows if ms > 0)} kernels and copies; "
            f"the two kernels "
            f"{ {k[:40]: (round(v[0], 4), v[1]) for k, v in ours.items()} }; "
            f"top: {top}")


def cut_depth_against_float32() -> dict:
    """gemma3-27b's first unit (6 layers, 5 local and 1 global) at full
    width: the float32 forward through the plain versions is the yardstick,
    and the bf16 forward through the kernels must come as close to it as
    the bf16 forward through the plain versions, within
    :data:`CUT_DEPTH_SLACK`.  The bf16 weights are the float32 ones rounded
    (one seed: ``init`` draws in float32 and casts)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(SERVE["arch"]), num_layers=6,
                              dtype="float32")
    model = build_model(cfg)
    p32 = model.init(1)
    toks, _ = TokenStream(cfg.vocab_size, 1).batch(0, 1, PREFILL_LEN)
    with plain_versions():
        l32, _ = model.forward(p32, toks)
    del p32
    p16 = build_model(dataclasses.replace(cfg, dtype="bfloat16")).init(1)
    lk, _ = model.forward(p16, toks)
    with plain_versions():
        lp, _ = model.forward(p16, toks)
    err_k, err_p = compare(lk, l32)["rel"], compare(lp, l32)["rel"]
    log(f"6 layers at full width, (1, {PREFILL_LEN}): bf16 logits through "
        f"the kernels {err_k:.4e} and through the plain versions {err_p:.4e} "
        f"from the float32 plain forward (relative)")
    check(err_k <= CUT_DEPTH_SLACK * err_p, ("cut depth", err_k, err_p))
    del p16, l32, lk, lp
    torch.cuda.empty_cache()
    return {"kernel_vs_f32": err_k, "plain_vs_f32": err_p}


def visible_pairs(S: int, window: int) -> int:
    """(query, key) pairs the causal mask (and the window) leave visible."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def time_model_kernels(inp: dict, launches: dict) -> list:
    """The records of RMSNorm at the prefill shape (and the decode shape)
    and flash attention at a global and a local layer of the prefill."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import (
        attention_bshd,
        attention_plain,
        rmsnorm,
        rmsnorm_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(6)
    rms = {}
    for n, d in RMS_SHAPES:
        x = (3 * torch.randn(n, d, generator=gen, device="cuda")).bfloat16()
        w = (0.1 * torch.randn(d, generator=gen, device="cuda")).bfloat16()
        w1 = 1 + w
        reps = 200 if n > 64 else 1000
        n_bytes = 2 * (2 * n * d + d)
        rms[(n, d)] = {
            "ms": cuda_ms(lambda: rmsnorm(x, w), reps),
            "device_ms": kernel_device_ms(lambda: rmsnorm(x, w), reps,
                                          "rmsnorm_kernel"),
            "plain_ms": cuda_ms(lambda: rmsnorm_plain(x, w), reps),
            "library_ms": cuda_ms(lambda: F.rms_norm(x, (d,), w1, 1e-6), reps),
            "library_device_ms": library_device_ms(
                lambda: F.rms_norm(x, (d,), w1, 1e-6), reps),
            # x read and the result written once, bf16; 4 operations an
            # element (square-add, then two multiplies and the cast)
            "bound": bound_ms(n_bytes, 4 * n * d),
        }
    flash = {}
    for heads, window in ((FLASH_HEADS, 0), (FLASH_HEADS, 1024),
                          (FLASH_WIDE_HEADS, FLASH_WIDE_WINDOW)):
        H, Hkv, Dh = heads
        q, k, v = flash_inputs(PREFILL_LEN, torch.bfloat16, 20, heads=heads)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window:
            pos = torch.arange(PREFILL_LEN, device="cuda")
            band = ((pos[None, :] <= pos[:, None])
                    & (pos[None, :] > pos[:, None] - window))
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=band, enable_gqa=True)
        else:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True, enable_gqa=True)
        pairs = visible_pairs(PREFILL_LEN, window)
        dev = median_device_ms(
            lambda: attention_bshd(q, k, v, window=window), 10,
            "flash_kernel")
        flash[(Dh, window)] = {
            "ms": cuda_ms(lambda: attention_bshd(q, k, v, window=window), 10),
            "device_ms": dev["median"],
            "device_ms_range": [dev["min"], dev["max"]],
            "device_ms_by": dev["by"],
            "empty_traces": dev["empty_traces"],
            "plain_ms": cuda_ms(lambda: attention_plain(q, k, v,
                                                        window=window), 3,
                                warmup=1),
            "library_ms": cuda_ms(lib, 10),
            "library_device_ms": library_device_ms(lib, 10),
            "visible_pairs": pairs,
            # q, k, v read and the output written once, bf16; Q·Kᵀ and P·V
            # over the visible pairs, 4·Dh operations a pair and head, at
            # the bf16 tensor-core rate
            "bound": bound_ms(2 * PREFILL_LEN * Dh * (2 * H + 2 * Hkv),
                              4 * Dh * H * pairs, PEAK_BF16_OPS_PER_S),
        }
        del q, k, v, qt, kt, vt
    log(f"rmsnorm (ms): {json.dumps({str(k): v for k, v in rms.items()})}")
    log(f"flash_attention (ms, by (Dh, window)): "
        f"{json.dumps({str(k): v for k, v in flash.items()})}")
    pre, dec = rms[RMS_SHAPES[0]], rms[RMS_SHAPES[1]]
    glob, loc = flash[(128, 0)], flash[(128, 1024)]
    wide = flash[(256, FLASH_WIDE_WINDOW)]
    H, Hkv, Dh = FLASH_HEADS
    return [
        {"name": "rmsnorm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm.py:35",
         "launches": launches["rmsnorm"], "max_abs_err": inp["rms_err"],
         "ms": pre["ms"], "plain_ms": pre["plain_ms"],
         "bound_ms": pre["bound"][0], "bound_by": pre["bound"][1],
         "library_ms": pre["library_ms"], "device_ms": pre["device_ms"],
         "library_device_ms": pre["library_device_ms"],
         "shape": list(RMS_SHAPES[0]), "dtype": "bfloat16",
         "at_decode_shape": {"shape": list(RMS_SHAPES[1]),
                             "ms": dec["ms"], "device_ms": dec["device_ms"],
                             "plain_ms": dec["plain_ms"],
                             "library_ms": dec["library_ms"],
                             "library_device_ms": dec["library_device_ms"],
                             "bound_ms": dec["bound"][0],
                             "bound_by": dec["bound"][1]}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:113",
         "launches": launches["flash_attention"],
         "max_abs_err": inp["flash_err"], "ms": glob["ms"],
         "plain_ms": glob["plain_ms"], "bound_ms": glob["bound"][0],
         "bound_by": glob["bound"][1], "library_ms": glob["library_ms"],
         "device_ms": glob["device_ms"],
         "device_ms_range": glob["device_ms_range"],
         "device_ms_by": glob["device_ms_by"],
         "empty_traces": glob["empty_traces"],
         "library_device_ms": glob["library_device_ms"],
         "shape": [1, PREFILL_LEN, H, Hkv, Dh], "dtype": "bfloat16",
         "window": 0, "visible_pairs": glob["visible_pairs"],
         "hgmma_in_sass": inp["hgmma"],
         "max_abs_err_dh256": inp["flash_wide_err"],
         "max_abs_err_by_q_scale": inp["flash_split_err"],
         "at_window_1024": {"ms": loc["ms"], "device_ms": loc["device_ms"],
                            "device_ms_range": loc["device_ms_range"],
                            "device_ms_by": loc["device_ms_by"],
                            "empty_traces": loc["empty_traces"],
                            "plain_ms": loc["plain_ms"],
                            "library_ms": loc["library_ms"],
                            "library_device_ms": loc["library_device_ms"],
                            "library": "scaled_dot_product_attention with a "
                                       "boolean band mask",
                            "visible_pairs": loc["visible_pairs"],
                            "bound_ms": loc["bound"][0],
                            "bound_by": loc["bound"][1]},
         "at_dh256": {"shape": [1, PREFILL_LEN, *FLASH_WIDE_HEADS],
                      "window": FLASH_WIDE_WINDOW, "ms": wide["ms"],
                      "device_ms": wide["device_ms"],
                      "device_ms_range": wide["device_ms_range"],
                      "device_ms_by": wide["device_ms_by"],
                      "empty_traces": wide["empty_traces"],
                      "plain_ms": wide["plain_ms"],
                      "library_ms": wide["library_ms"],
                      "library_device_ms": wide["library_device_ms"],
                      "library": "scaled_dot_product_attention with a "
                                 "boolean band mask",
                      "visible_pairs": wide["visible_pairs"],
                      "bound_ms": wide["bound"][0],
                      "bound_by": wide["bound"][1]}},
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
                               label="sparse-center",
                               kernels=("cubic_solve", "topk_compress",
                                        "sparse_agg"))
    w8a_payload = w8a_sparse_payloads()
    f1 = check_f1(*w8a_payload)
    rule_launches = {}
    for rule, kernel in W8A_RULES.items():
        rule_launches[rule], _ = drive(
            dict(W8A, attack="gaussian", aggregator=rule), 3, sparse=False,
            kernels=("cubic_solve", "topk_compress", kernel),
            label=rule.partition(":")[0])

    # gisette's width: the sharded top-k and the sparse center
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
    widths = check_cubic_widths()
    wide = check_cubic_wide()
    check_small_against_cpu()
    check_sparse_spec_against_cpu(
        SMALL_LARGE_D, 2, "small spec at d = 4352 (sharded top-k, sparse "
        "center)", 1e-5)

    # slice 4: the model zoo's dense decoder, gemma3-27b at full width
    model_inp = check_model_kernels()
    check_small_model_against_cpu()
    serve = serve_full_width()
    prefill = prefill_full_width()
    cut_depth_against_float32()

    # each kernel's launches in the first run that drives it
    runs = {"ef21_norm_trim_5_rounds": launches,
            "sparse_center_3_rounds": sparse_launches,
            **{f"{rule}_3_rounds": n for rule, n in rule_launches.items()},
            "gisette_sparse_center_3_rounds": a_launches,
            "gisette_adaptive_k_4_rounds": b_launches,
            "serve_gemma3_27b_4x(32+32)": serve["launches"],
            "prefill_gemma3_27b_1x4096": prefill["launches"]}
    first = {name: next((n[name] for n in runs.values() if n[name]), 0)
             for name in launches}
    kernels = time_kernels(inputs, first)
    kernels[0].update(at_gisette=ginp["cubic"], at_widths=widths,
                      at_d10000=wide)
    kernels += time_gisette_kernels(ginp, first, w8a_payload)
    kernels[-1]["f1"] = f1
    topk = time_topk()
    for rec in kernels:
        if rec["name"] in ("topk_compress", "topk_sharded"):
            rec["timed"] = {key: t for key, t in topk.items()
                            if t["name"] == rec["name"]}
    kernels += time_model_kernels(model_inp, first)
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
