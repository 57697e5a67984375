#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only [--src OTHER_TREE/src]

Phases, each of which fails the run (non-zero exit, no result line):

1. build      compile every CUDA kernel of the port from `src/repro_torch/
              kernels/csrc` with nvcc (first use, one nvcc per source, all
              at once) and print the build time, ptxas's register and spill
              report and each kernel's largest spill;
2. kernels    hold each kernel against its plain PyTorch version on the
              card, and a second launch against the first, bit for bit —
              ell_histogram: equal for integer and random float weights;
              swa_attention: at the serve shape
              with ragged pos and at edge shapes, float32 at rtol 1e-5 /
              atol 1e-5 and bf16 within one bf16 ulp (rtol 8e-3 /
              atol 1e-3) — and time kernel, plain version and one library
              call computing the same function: the histogram at
              (65536, 8, 32) and (4096, 64, 4096) beside scatter_add_, SWA
              at the serve shape warm in L2 and with L2 flushed, and at
              decode_32k, beside scaled_dot_product_attention;
3. parity     the device V-cycle (engine "torch" on cuda) against the
              port's host `sparse` engine on batch models of a mesh and an
              R-MAT graph in every forced aggregation mode, a whole driver
              run on R-MAT 2^16, and one batch run twice bit-identically;
              then, logged and not required, the R-MAT batch at Fennel
              gamma 1.25 and 2.5, where the device penalty uses CUDA's pow;
4. auto       the default engine (`MultilevelConfig()`: "auto" on cuda,
              the host V-cycle with the histogram kernel on the card)
              through the driver at the paper's delta = 32768: labels and
              cut equal to the host `sparse` engine's, histogram launches
              on this route, and the kernel held against its plain version
              on the largest and the last inputs the route gave it, and
              timed on the largest against its bound and scatter_add_;
5. full       the BuffCut driver at full width: grid mesh 1024x1024
              (n = 2^20) with the paper's §4 settings (k=32, eps=0.03,
              Q=262144, delta=32768, HAA) on the device engine; requires
              valid labels, an exact streamed cut, histogram kernel
              launches on this path and one sweep kernel launch per device
              V-cycle;
6. profile    per-stage time of one full-width batch V-cycle, each stage
              synchronized, and the initial partition's step count; keeps
              the coarsest level for phase 13;
7. serve      `repro_torch.launch.serve.serve_lm` at h2o-danube-1.8b's
              full width (24 layers, d=2560, bf16, random weights from a
              seeded generator): batch 4, an 8192-token prompt, 32 greedy
              decode steps; requires finite logits and 24 x 32 launches of
              the swa_attention kernel; reports prefill time, decode tokens/s
              and peak memory, and profiles one decode step (the kernel's
              share of it and its time per launch; logged as not measured
              where no profiler trace of it is complete);
8. decode     the same model in float32 with TF32 off: batch 1, a
              4608-token prompt (past the 4096 window) and 4 decode steps;
              decode logits (the kernel) must equal forward_train's (plain
              torch flash attention) at rtol 1e-3 / atol 1e-3;
9. bag        dlrm-mlperf's full-width tables (26 x 2^20 x 128 float32,
              drawn on the card), and the embedding_bag kernel held bit for
              bit against its plain version on them at batch 512 and 262144
              with L = 1 (the path) and L = 2 (weighted), indices -1 and V
              clamping; times kernel, plain version and one
              torch.nn.functional.embedding_bag call at both batches;
10. fennel    the fennel_gain kernels held bit for bit (best and score)
              against their plain version at (B, W, k) = (32768, 64, 32)
              with integer and fractional weights, at k = 1000 and at W = 6,
              each at gamma 1.25, 1.5, 2, 2.5, 3 and 4, and with no feasible
              block; times the call (device_ms: one launch), warm and with
              L2 flushed, at the first;
11. ops       the four public ops of `repro_torch.kernels`, each called once
              at a main-path shape: each launches its kernel exactly once;
12. dlrm      `serve_dlrm` at dlrm-mlperf's full_config on the card at
              serve_p99 (batch 512) and serve_bulk (batch 262144), 10 timed
              forwards each after one warm-up, exactly one bag launch per
              forward; the first 64 logits against a float64 forward on the
              CPU (those rows' gathered table rows and the MLP weights) at
              rtol 1e-4 and atol 1e-4 of the largest logit; one forward's
              device time and its bag call's (CUDA events), and its device
              rows where a profiler trace is complete; dlrm_retrieval at
              retrieval_cand (10^6 candidates);
13. sweep     the initial Fennel sweep of phase 6's coarsest level (the
              full-width batch: ~12k free nodes, k = 32): the sweep kernel
              held against its plain version (the eager step loop) bit for
              bit, labels and loads, and timed: the call (two clones and the
              launch), the `_initial_fennel` stage and the plain version once;
14. pipe      `buffcut_partition_pipelined` at phase 5's full width with
              PipelineConfig() (queue 4, prefetch 2): labels bit-equal to
              phase 5's (cut and balance too), histogram launches and one
              sweep launch per V-cycle, every V-cycle on a worker thread;
              prints runtime_s, ml_time_s, nodes/s and T2's time (runtime_s
              minus its waits on T3) beside phase 5's, the same run's with
              prefetch_batches=0, and the time of the prefetch pump's
              per-record resume tokens over the whole stream.  Then on phase 3's
              R-MAT inside torch.cuda.stream(s): every V-cycle on stream s
              and off the calling thread, labels equal to the sequential
              driver's, and buffcut_partition(prefetch_batches=2) equal to
              prefetch_batches=0;
15. vec       `buffcut_partition_vectorized` at the same full width with
              wave = chunk = 32 (the incremental VectorBuffer): valid
              labels, an exact streamed cut, the balance cap, histogram
              launches and one sweep per V-cycle; prints runtime_s,
              ml_time_s and the cut ratio beside phase 5's.  Then on phase
              3's R-MAT at wave = chunk = 1: evictions and labels equal to
              the sequential driver's on the device engine.

Phase 2 also runs swa_attention's general paths (G = 32, D = 36 in bf16, a
strided q with an int64 pos) and phase 10 fennel_gain at k = 65,536 (the
row in device memory), each against its plain version.

Kernel times are device times from CUDA events around calls enqueued
behind a spin kernel (`device_ms`); `--kernels-only` also reads the kernel
alone from its rows in a profiler trace (`device_rows`), which an earlier
tree's fennel_gain call needs (it enqueued torch ops beside the kernel).
Profiler traces late in a long run can come back incomplete; no check
rests on them, and the rows of such a run are logged as not measured.

`--kernels-only` builds and runs only the timings of the fennel_gain kernel
(phase 10's) and of the initial sweep on its path (phase 6's stage split,
then phase 13's times where the tree has the sweep kernel; an earlier tree's
eager sweep is timed as its `_initial_fennel` stage), and the swa_attention
wrapper's host time per call at the serve shape and decode_32k, and prints
no result line; with `--src` it takes repro_torch from another tree, so that an
earlier commit (unpacked with `git archive` into a directory `.gitignore`
lists) is timed by the same code on the same card.

The port has no host fallback: an error of a device engine fails the run.

The second-to-last lines are the kernel JSON line and the card's name and
power limit; the last line is {"ok": true, "device": {...}}.  Imports
nothing of JAX or of the JAX package `repro`.
"""
from __future__ import annotations

import dataclasses
import importlib
import inspect
from collections import Counter
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published peaks of one H100 SXM (NVIDIA data sheet), for bound_ms
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# (B, W, k): the main path's level-0 refinement shape first, then a
# clustering-sized label domain, widths outside the specialised ones, k not
# a multiple of 4 or of 32, and B not a multiple of a block's rows
HIST_SHAPES = [(65536, 8, 32), (4096, 64, 4096), (7, 13, 4), (1, 1, 2), (64, 16, 1000),
               (1001, 8, 30), (333, 24, 2050), (70, 64, 5000)]

# the auto route's mesh: n = 33124, one batch of delta = 32768 and a tail
AUTO_SIDE = 182

# the serve phase: h2o-danube-1.8b at full width, batch 4, 8192-token prompt
SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS = 4, 8192, 32
# (B, S, KVH, G, D, window, pos): the serve path's decode shape with ragged
# pos (some splits empty, pos mid-chunk), then pos = 0, a window wider than
# the cache, D = 64 and 128, G = 1, a window that is no multiple of the
# chunk, one empty row among full ones, and G = 16 over a window of 8192
SWA_SHAPES = [
    (4, SERVE_PROMPT + SERVE_TOKENS + 1, 8, 4, 80, 4096, (8192, 5000, 4096, 37)),
    (3, 64, 8, 4, 80, 4096, (0, 0, 0)),
    (2, 100, 2, 4, 80, 4096, (100, 60)),
    (2, 300, 4, 4, 64, 128, (300, 7)),
    (2, 300, 4, 4, 128, 128, (250, 129)),
    (2, 300, 8, 1, 80, 64, (300, 1)),
    (3, 3000, 8, 4, 80, 2500, (3000, 0, 1777)),
    (1, 8192, 1, 16, 128, 8192, (8192,)),
]
# (B, S, KVH, G, D, window, pos, dtype): shapes the reference's op takes
# and the kernel alone does not, run by the wrapper's general paths: G = 32
# (two launches of 16 heads), D = 36 in bf16 (72 bytes, padded to 80)
SWA_GENERAL = [(4, 2048, 2, 32, 80, 1024, (2048, 1500, 700, 3), "bfloat16"),
               (4, 2048, 8, 4, 36, 1024, (2048, 1500, 700, 3), "bfloat16")]
# decode_32k of configs/lm_common.py: batch 128 against a 32768-token cache
SWA_DECODE_32K = (128, 32768)
# the swa_attention kernel's rows in a profiler trace (swa_split_kernel on
# the CUDA cores, swa_split_mma_kernel on the tensor cores; one per launch)
SWA_KERNEL_ROW = "swa_"

# dlrm-mlperf's serve shapes (configs/dlrm_mlperf.py SHAPES)
DLRM_P99, DLRM_BULK, DLRM_CANDIDATES = 512, 262144, 1_000_000
DLRM_ITERS = 10
# (B, W, k, weights): the public op's shape (the staged kernel) with integer
# and fractional weights, then k past a warp and W no multiple of 4 (the
# general kernel); each at every gamma of FENNEL_GAMMAS, the first timed at
# FENNEL_GAMMAS[1]
FENNEL_SHAPES = [(32768, 64, 32, "int"), (32768, 64, 32, "float"), (32768, 64, 1000, "float"),
                 (32768, 6, 32, "float")]
FENNEL_GAMMAS = (1.25, 1.5, 2.0, 2.5, 3.0, 4.0)
FENNEL_ALPHA, FENNEL_CAP = 0.05, 90.0
# (B, W, k): the public op past shared memory (the row in device memory)
FENNEL_LARGE_K = (4096, 16, 65536)
# the sweep's dependent chain a step, a floor: one on-chip read of a
# neighbour's label written a step earlier, then the five shuffle rounds of
# the argmax over k = 32 blocks, each a dependent round trip of ~30 SM
# cycles (the update of one load overlaps the next step's reads)
SWEEP_STEP_CYCLES = 6 * 30
# float64 rate of one H100 SXM outside the tensor cores (NVIDIA data sheet)
FP64_OPS_PER_S = 34e12


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of one call of `fn` between two CUDA events: the
    device time plus whatever host time the call keeps the device waiting
    (launch overhead dominates small kernels)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, samples: int = 5, reps: int = 10, warmup: int = 3, before=None) -> float:
    """Milliseconds of device time per call of `fn`: the median over
    `samples` of two CUDA events recorded around `reps` back-to-back calls,
    divided by `reps`, while a spin kernel (`torch.cuda._sleep`) keeps the
    card busy so that the host's time to enqueue the calls is not counted.
    An event recorded behind the spin must still be pending once the calls
    and the closing event are enqueued; if it is not, the sample is taken
    again with the spin doubled, up to ~35 ms, and then with half the
    calls (the card queues about a thousand launches, and a plain version
    that launches hundreds per call fills the queue).  A call that waits on
    the card, such as a copy to the device, can never pass.  `before`, if
    given, is enqueued ahead of the first event (an L2 flush)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = 1 << 21
    times = []
    while len(times) < samples:
        behind, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        torch.cuda._sleep(spin)
        behind.record()
        if before is not None:
            before()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        busy = not behind.query()
        end.synchronize()
        if busy:
            times.append(start.elapsed_time(end) / reps)
        elif spin < 1 << 26:
            spin *= 2
        else:
            check(reps > 1, "the host never finished enqueueing one call within the spin")
            reps //= 2
    times.sort()
    return times[len(times) // 2]


def host_us(fn, calls: int = 50) -> float:
    """Microseconds of host time per call of `fn` (the wrapper's checks,
    allocations and launch), taken while a spin kernel keeps the card busy,
    so that no call waits on the card; the median of 5 samples."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    while len(times) < 5:
        behind = torch.cuda.Event()
        torch.cuda._sleep(1 << 26)
        behind.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        dt = time.perf_counter() - t0
        busy = not behind.query()
        torch.cuda.synchronize()
        if busy:
            times.append(dt / calls * 1e6)
        else:
            check(calls > 1, "the host never finished one call within the spin")
            calls //= 2
    times.sort()
    return times[len(times) // 2]


def device_rows(fn, iters: int, want: str, expect: int, attempts: int = 3) -> dict | None:
    """{row name: device ms per call} over `iters` calls of `fn`, from a
    torch.profiler trace of device activity only (each row one kernel,
    memset or copy, none counted twice).  On the card, traces late in a
    long run have come back empty or missing records, so a trace counts
    only when it holds `expect` launches of the kernel named `want`; one
    that does not is logged and taken again.  Other rows may still miss a
    few records, which understates device time a little.  None when no
    trace in `attempts` was complete: the rows are then not measured, and
    no check of the run rests on them (the launch counts are the wrappers'
    own, and every time a result needs is taken with CUDA events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        avgs = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        found = sum(e.count for e in avgs if want in e.key)
        if found == expect:
            return {e.key: e.self_device_time_total / iters / 1e3 for e in avgs}
        log(f"[env] profiler trace {attempt} of {attempts} ({iters} calls) holds {found} "
            f"launches of {want}, expected {expect}")
    log(f"[env] no profiler trace in {attempts} attempts held every {want} launch: "
        f"device rows not measured")
    return None


# ------------------------------------------------------------------ phases

def phase_build() -> float:
    from repro_torch.kernels import _build

    secs = _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
        log(f"[build] {name}: {_build.library_path(name).name}")
        spilled = 0
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Function properties" in line:
                log(f"[build]   {line.strip()[:160]}")
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if found:
                spilled = max(spilled, int(found[1]), int(found[2]))
        log(f"[build] {name}: largest spill of any instantiation {spilled} bytes")
    log(f"[build] all kernels built and loaded in {secs:.2f} s")
    return secs


def hist_inputs(b: int, w: int, k: int, seed: int, integer: bool):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    blk = rng.integers(-1, k, (b, w)).astype(np.int32)
    if integer:
        wts = rng.integers(1, 5, (b, w)).astype(np.float32)
    else:
        wts = rng.random((b, w)).astype(np.float32)
    wts *= blk >= 0
    return torch.from_numpy(blk).cuda(), torch.from_numpy(wts).cuda()


def hist_time(blk, wts, k: int, what: str, samples: int = 5) -> dict:
    """Device times (ms) of the kernel, its plain version and one
    scatter_add_ computing the same counts (the flat index precomputed; a
    yardstick only, the port never calls it), and the kernel's bound."""
    import torch

    from repro_torch.kernels import ell_histogram as eh

    b, w = blk.shape
    rows = torch.arange(b, device="cuda")[:, None]
    flat = (rows * k + blk.clamp(min=0).long()).view(-1)  # -1 entries carry weight 0
    wflat = wts.view(-1)
    calls = {
        "kernel": lambda: eh.block_histogram(blk, wts, k),
        "plain": lambda: eh.ell_histogram_plain(blk, wts, k),
        "scatter_add_": lambda: torch.zeros(b * k, device="cuda").scatter_add_(0, flat, wflat),
    }
    torch.testing.assert_close(calls["kernel"](), calls["scatter_add_"]().view(b, k),
                               rtol=1e-6, atol=1e-5)
    dev = {name: device_ms(fn, samples=samples) for name, fn in calls.items()}
    wall = time_cuda(calls["kernel"])
    # each entry read once, the counts written once; compares and one add
    # per valid entry
    bnd, by = bound(b * w * 8 + b * k * 4, b * w * k + int((blk >= 0).sum()))
    log(f"[kernels] ell_histogram {(b, w, k)} {what}: kernel {dev['kernel']:.5f} ms "
        f"(event-timed call {wall:.5f} ms), plain {dev['plain']:.5f} ms, scatter_add_ "
        f"{dev['scatter_add_']:.5f} ms; bound {bnd:.5f} ms ({by})")
    return {"ms": dev["kernel"], "plain_ms": dev["plain"], "library_ms": dev["scatter_add_"],
            "bound_ms": bnd, "bound_by": by}


def phase_kernels() -> dict:
    import torch

    from repro_torch.kernels import ell_histogram as eh

    worst = 0.0
    for i, (b, w, k) in enumerate(HIST_SHAPES):
        for integer in (True, False):
            blk, wts = hist_inputs(b, w, k, seed=i, integer=integer)
            got = eh.block_histogram(blk, wts, k)
            want = eh.ell_histogram_plain(blk, wts, k)
            torch.cuda.synchronize()
            check(got.shape == (b, k) and got.dtype == torch.float32,
                  f"ell_histogram shape/dtype {tuple(got.shape)} {got.dtype}")
            err = float((got - want).abs().max()) if got.numel() else 0.0
            worst = max(worst, err)
            # one thread sums each count in w order, as the plain version
            check(torch.equal(got, want), f"ell_histogram differs from its plain version at "
                                          f"{(b, w, k)} ({'int' if integer else 'float'} weights)")
            check(torch.equal(got, eh.block_histogram(blk, wts, k)),
                  f"ell_histogram: a second launch differs at {(b, w, k)}")
            log(f"[kernels] ell_histogram {(b, w, k)} "
                f"{'int' if integer else 'float'} weights: equal to the plain version bit for "
                f"bit, a second launch too")

    # times at the main path's shape (level-0 refinement of a full batch)
    # and at a clustering-sized label domain
    timed = {}
    for b, w, k in HIST_SHAPES[:2]:
        blk, wts = hist_inputs(b, w, k, seed=0, integer=False)
        timed[(b, w, k)] = hist_time(blk, wts, k, "random float weights")
        del blk, wts
    torch.cuda.empty_cache()
    return {
        "name": "ell_histogram",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ell_histogram.cu",
        "replaces": "src/repro/kernels/ell_histogram.py:44",
        "launches": 0,
        "max_abs_err": worst,
        **timed[HIST_SHAPES[0]],
    }


def swa_inputs(b, s, kvh, g, d, pos, dtype, seed: int):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, kvh, g, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, s, kvh, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, s, kvh, d), generator=gen, device="cuda").to(dtype)
    return q, k, v, torch.tensor(pos, dtype=torch.int32, device="cuda")


def swa_bound_ms(kvh: int, g: int, d: int, window: int, s: int, pos, itemsize: int):
    """(bound in ms, by what): each valid K and V row read once, q read and
    the output written once; 4·G·D float32 operations per valid position
    (the two products), at the card's float32 rate."""
    n = sum(max(0, min(p, s) - max(p - window, 0)) for p in pos)
    b = len(pos)
    bytes_moved = 2 * n * kvh * d * itemsize + 2 * b * kvh * g * d * itemsize + 4 * b
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * n * kvh * g * d / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def swa_time(b: int, s: int, pos, masked_sdpa: bool) -> dict:
    """Device times (ms) at the serve path's head layout in bf16 of the
    kernel (warm in L2, and with L2 flushed before each call), its plain
    version and one scaled_dot_product_attention call on the window (a
    view of the cache; every row has the same pos) as the library time;
    with `masked_sdpa`, also SDPA over the whole cache with the window as a
    boolean mask.  SDPA is a yardstick only: the port never calls it.  Also
    the wrapper's host time per call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import swa_attention as sw

    kvh, g, d, window = 8, 4, 80, 4096
    check(len(set(pos)) == 1, "swa_time takes one pos for every row")
    q, k, v, p = swa_inputs(b, s, kvh, g, d, pos, torch.bfloat16, seed=b)
    lo, hi = max(0, pos[0] - window), min(pos[0], s)
    qh = q.view(b, kvh * g, 1, d)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    scale = 1.0 / d ** 0.5
    calls = {
        "kernel": lambda: sw.swa_attention_decode(q, k, v, p, window=window),
        "plain": lambda: sw.swa_attention_decode_plain(q, k, v, p, window=window),
        "sdpa": lambda: F.scaled_dot_product_attention(
            qh, kh[:, :, lo:hi], vh[:, :, lo:hi], scale=scale, enable_gqa=True),
    }
    if masked_sdpa:
        j = torch.arange(s, device="cuda")
        mask = ((j >= lo) & (j < hi))[None, None, None, :]
        calls["sdpa_masked"] = lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, scale=scale, enable_gqa=True)
    got = calls["kernel"]()
    torch.testing.assert_close(got, calls["plain"](), rtol=8e-3, atol=1e-3)
    check(torch.equal(got, calls["kernel"]()), "swa_attention: a second launch differs")
    for name in ("sdpa", "sdpa_masked"):
        if name in calls:  # the library's bf16 route rounds at other points
            torch.testing.assert_close(got.view(b, kvh * g, 1, d), calls[name](), rtol=2e-2,
                                       atol=2e-3)
    del got
    dev = {name: device_ms(fn) for name, fn in calls.items()}
    wall = time_cuda(calls["kernel"])
    # the same launch after 64 MB of writes: K and V not in the 50 MB L2
    flush = torch.empty(2**24, device="cuda")
    cold = device_ms(calls["kernel"], samples=20, reps=1, before=flush.zero_)
    del flush
    host = host_us(calls["kernel"])
    # the launch's kernels one by one, from a profiler trace
    rows = device_rows(calls["kernel"], 10, want=SWA_KERNEL_ROW, expect=10)
    if rows is not None:
        log(f"[kernels] swa_attention B={b} S={s}: kernels of one launch (profiler): "
            + "; ".join(f"{key.split('(')[0][-40:]} {ms * 1e3:.2f} us"
                        for key, ms in rows.items()))
    bnd, by = swa_bound_ms(kvh, g, d, window, s, pos, 2)
    masked = f", sdpa with a mask over the cache {dev['sdpa_masked']:.5f} ms" if masked_sdpa else ""
    log(f"[kernels] swa_attention B={b} S={s} pos={pos[0]} bf16: kernel {dev['kernel']:.5f} ms "
        f"warm ({cold:.5f} ms with L2 flushed, event-timed call {wall:.5f} ms, host time per "
        f"call {host:.2f} us), plain {dev['plain']:.5f} ms, sdpa on the window "
        f"{dev['sdpa']:.5f} ms{masked}; bound {bnd:.5f} ms ({by})")
    del q, k, v, kh, vh, calls
    torch.cuda.empty_cache()
    return {"ms": dev["kernel"], "plain_ms": dev["plain"], "library_ms": dev["sdpa"],
            "bound_ms": bnd, "bound_by": by}


def phase_swa_kernel() -> dict:
    import torch

    from repro_torch.kernels import swa_attention as sw

    worst = 0.0
    for i, (b, s, kvh, g, d, window, pos) in enumerate(SWA_SHAPES):
        for dtype, rtol, atol in ((torch.float32, 1e-5, 1e-5), (torch.bfloat16, 8e-3, 1e-3)):
            q, k, v, p = swa_inputs(b, s, kvh, g, d, pos, dtype, seed=i)
            got = sw.swa_attention_decode(q, k, v, p, window=window)
            want = sw.swa_attention_decode_plain(q, k, v, p, window=window)
            torch.cuda.synchronize()
            check(got.shape == q.shape and got.dtype == dtype,
                  f"swa_attention shape/dtype {tuple(got.shape)} {got.dtype}")
            err = float((got.float() - want.float()).abs().max())
            worst = max(worst, err)
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
            check(torch.equal(got, sw.swa_attention_decode(q, k, v, p, window=window)),
                  "swa_attention: a second launch differs")
            if max(pos) == 0:
                check(not bool(got.any()), "swa_attention: an empty window must give zeros")
            log(f"[kernels] swa_attention (B={b}, S={s}, KVH={kvh}, G={g}, D={d}, "
                f"window={window}, pos={pos}) {str(dtype)[6:]}: max_abs_err={err:g}, a second "
                f"launch bit-identical")
    for i, (b, s, kvh, g, d, window, pos, dtype) in enumerate(SWA_GENERAL):
        q, k, v, p = swa_inputs(b, s, kvh, g, d, pos, getattr(torch, dtype), seed=50 + i)
        before = sw.launches
        got = sw.swa_attention_decode(q, k, v, p, window=window)
        check(sw.launches - before == -(-g // 16), "swa_attention: one launch per 16 heads")
        want = sw.swa_attention_decode_plain(q, k, v, p, window=window)
        torch.testing.assert_close(got, want, rtol=8e-3, atol=1e-3)
        # non-contiguous q (a transposed view) and an int64 pos
        qt = q.transpose(1, 2).contiguous().transpose(1, 2)
        got_t = sw.swa_attention_decode(qt, k, v, p.to(torch.int64), window=window)
        check(not qt.is_contiguous() and torch.equal(got_t, got),
              "swa_attention: a strided q with int64 pos differs from the contiguous call")
        err = float((got.float() - want.float()).abs().max())
        worst = max(worst, err)
        log(f"[kernels] swa_attention general path (B={b}, S={s}, KVH={kvh}, G={g}, D={d}, "
            f"window={window}) {dtype}: max_abs_err={err:g} against the plain version; a "
            f"strided q with int64 pos gives the same bits")
    serve_s = SWA_SHAPES[0][1]
    timed = swa_time(SERVE_BATCH, serve_s, (serve_s - 1 - SERVE_TOKENS,) * SERVE_BATCH, True)
    b32, s32 = SWA_DECODE_32K
    swa_time(b32, s32, (s32,) * b32, False)
    return {
        "name": "swa_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/swa_attention.cu",
        "replaces": "src/repro/kernels/swa_attention.py:26",
        "launches": 0,
        "max_abs_err": worst,
        **timed,
    }


def swa_host(reps: int = 5) -> None:
    """The swa_attention wrapper's host time per call in bf16 at the serve
    shape and at decode_32k: the median, least and most of `reps` readings
    of `host_us` (200 calls each), so that two trees' wrappers can be
    compared on one card."""
    import torch

    from repro_torch.kernels import swa_attention as sw

    kvh, g, d, window = 8, 4, 80, 4096
    serve_s = SWA_SHAPES[0][1]
    b32, s32 = SWA_DECODE_32K
    for b, s, pos in ((SERVE_BATCH, serve_s, serve_s - 1 - SERVE_TOKENS), (b32, s32, s32)):
        q, k, v, p = swa_inputs(b, s, kvh, g, d, (pos,) * b, torch.bfloat16, seed=b)
        got = sorted(host_us(lambda: sw.swa_attention_decode(q, k, v, p, window=window), 200)
                     for _ in range(reps))
        log(f"[kernels] swa_attention B={b} S={s} pos={pos} bf16: wrapper host time per call "
            f"{got[reps // 2]:.2f} us (median of {reps} readings; {got[0]:.2f} .. "
            f"{got[-1]:.2f} us)")
        del q, k, v, p
    torch.cuda.empty_cache()


def batch_model_case(g, batch_lo: int, batch_hi: int, k: int, seed: int):
    """A batch model in mid-stream: nodes before `batch_lo` assigned at
    random, the batch [batch_lo, batch_hi) free."""
    import numpy as np

    from repro_torch.core.batch_model import build_batch_model
    from repro_torch.core.fennel import FennelParams

    rng = np.random.default_rng(seed)
    block = np.full(g.n, -1, dtype=np.int64)
    block[:batch_lo] = rng.integers(0, k, batch_lo)
    loads = np.bincount(block[:batch_lo], weights=g.node_w[:batch_lo],
                        minlength=k).astype(np.float64)
    model = build_batch_model(g, np.arange(batch_lo, batch_hi), block, k)
    p = FennelParams(k=k, n_total=float(g.node_w.sum()), m_total=g.total_edge_weight(),
                     eps=0.03)
    return model, p, loads


def phase_parity() -> None:
    import numpy as np

    import repro_torch.core.multilevel_torch as mlt
    from repro_torch.core import BuffCutConfig, MultilevelConfig, buffcut_partition
    from repro_torch.core.multilevel import multilevel_partition
    from repro_torch.graphs import grid_mesh_graph, rmat_graph
    from repro_torch.kernels import ell_histogram as eh

    host = MultilevelConfig(engine="sparse", device="cpu")
    dev = MultilevelConfig(engine="torch", device="cuda")
    for name, g in (("grid_mesh_graph(128)", grid_mesh_graph(128)),
                    ("rmat_graph(2**14, 8)", rmat_graph(2**14, 8, seed=1))):
        model, p, loads = batch_model_case(g, 4096, 8192, 32, seed=2)
        ref = multilevel_partition(model.graph, model.pinned_block, p, loads, host)
        for mode in ("dense", "sort", "ell"):
            mlt.MODE_OVERRIDE = mode
            before = eh.launches
            try:
                t0 = time.perf_counter()
                got = multilevel_partition(model.graph, model.pinned_block, p, loads, dev)
                dt = time.perf_counter() - t0
            finally:
                mlt.MODE_OVERRIDE = None
            check(np.array_equal(ref, got), f"torch engine ({mode}) != sparse on {name}")
            if mode == "ell":
                check(eh.launches > before, f"ell mode launched no kernel on {name}")
            log(f"[parity] {name} batch model n={model.graph.n}: torch/{mode} == sparse "
                f"({dt:.3f} s, {eh.launches - before} kernel launches)")
        first, second = (multilevel_partition(model.graph, model.pinned_block, p, loads, dev)
                         for _ in range(2))
        check(np.array_equal(first, second), f"repeat run differs on {name}")
        log(f"[parity] {name}: same batch twice on the card is bit-identical")
    # gamma outside {1.5, 2, 3}: the device penalty takes CUDA's pow, the
    # host numpy's; logged, not required (ROADMAP Queue 3)
    for gamma in (1.25, 2.5):
        pg = dataclasses.replace(p, gamma=gamma)
        ref = multilevel_partition(model.graph, model.pinned_block, pg, loads, host)
        got = multilevel_partition(model.graph, model.pinned_block, pg, loads, dev)
        log(f"[parity] {name} batch model, gamma={gamma}: torch/cuda labels "
            f"{'==' if np.array_equal(ref, got) else '!='} sparse "
            f"({int((ref != got).sum())} of {ref.size} differ)")

    g = rmat_graph(2**16, 8, seed=0)
    base = BuffCutConfig(k=32, buffer_size=16384, batch_size=8192, ml=host)
    t0 = time.perf_counter()
    b_host, s_host = buffcut_partition(g, base)
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    b_dev, s_dev = buffcut_partition(g, dataclasses.replace(base, ml=dev))
    t_dev = time.perf_counter() - t0
    check(np.array_equal(b_host, b_dev), "driver labels differ between sparse and torch/cuda")
    check(s_host.cut_weight == s_dev.cut_weight, "driver cut differs between engines")
    log(f"[parity] driver on rmat_graph(2**16, 8), k=32, Q=16384, delta=8192: identical labels, "
        f"cut {s_dev.cut_weight:.0f}; sparse {t_host:.2f} s, torch/cuda {t_dev:.2f} s")


def full_width_config():
    from repro_torch.core import BuffCutConfig, MultilevelConfig

    # configs/buffcut_paper.py::paper_config (paper §4), device engine
    return BuffCutConfig(k=32, eps=0.03, buffer_size=262144, batch_size=32768,
                         d_max=10000.0, score="haa", disc_factor=1000,
                         ml=MultilevelConfig(engine="torch", device="cuda"))


def phase_auto(side: int) -> float:
    """The default engine through the driver at the paper's settings, held
    against the host `sparse` engine; returns the kernel's largest error
    against its plain version on the inputs this route gave it."""
    import numpy as np
    import torch

    import repro_torch.core.histogram as hist
    from repro_torch.core import MultilevelConfig, buffcut_partition
    from repro_torch.graphs import grid_mesh_graph
    from repro_torch.kernels import ell_histogram as eh

    g = grid_mesh_graph(side)
    cfg = dataclasses.replace(full_width_config(), ml=MultilevelConfig())
    check(cfg.ml.engine == "auto" and cfg.ml.device == "cuda", "the default engine moved")
    inputs = {}  # (B, W, k) -> the first inputs of that shape
    shapes = []
    wrapper = hist.block_histogram

    def recording(nbr_blk, nbr_w, k):
        shapes.append((*nbr_blk.shape, int(k)))
        inputs.setdefault(shapes[-1], (nbr_blk, nbr_w))
        return wrapper(nbr_blk, nbr_w, k)

    hist.block_histogram = recording
    try:
        eh.launches = 0
        block, stats = buffcut_partition(g, cfg)
        launches = eh.launches
    finally:
        hist.block_histogram = wrapper
    check(launches > 0, "the auto engine launched no ell_histogram kernel")
    host_cfg = dataclasses.replace(cfg, ml=MultilevelConfig(engine="sparse", device="cpu"))
    t0 = time.perf_counter()
    b_host, s_host = buffcut_partition(g, host_cfg)
    t_host = time.perf_counter() - t0
    check(np.array_equal(block, b_host), "auto/cuda labels differ from the sparse engine's")
    check(stats.cut_weight == s_host.cut_weight, "auto/cuda cut differs from the sparse engine's")
    largest = max(inputs, key=lambda s: s[0] * s[2])
    log(f"[auto] largest (B, W, k) {largest}, last {shapes[-1]}")
    out_gb = sum(b * k for b, _, k in shapes) * 4 / 1e9
    log(f"[auto] grid_mesh_graph({side}) n={g.n}, paper settings, MultilevelConfig() "
        f"(auto on cuda): batches={stats.n_batches} cut={stats.cut_weight:.0f} == sparse; "
        f"runtime_s={stats.runtime_s:.3f} ml_time_s={stats.ml_time_s:.3f} "
        f"(sparse on the host {t_host:.3f} s); ell_histogram launches={launches}, "
        f"{out_gb:.3f} GB of counts written; calls per (B, W, k): "
        f"{sorted(Counter(shapes).items())}")
    worst = 0.0
    for shape in dict.fromkeys((largest, shapes[-1])):
        blk, wts = inputs[shape]
        got = eh.block_histogram(blk, wts, shape[2])
        want = eh.ell_histogram_plain(blk, wts, shape[2])
        err = float((got - want).abs().max())
        check(torch.equal(got, want), f"ell_histogram differs from its plain version on the "
                                      f"route's input {shape} (max abs err {err:g})")
        worst = max(worst, err)
        log(f"[auto] ell_histogram {shape} from the route: equal to the plain version bit for bit")
        del got, want
    torch.cuda.empty_cache()
    hist_time(*inputs[largest], largest[2], "the auto route's largest input", samples=3)
    inputs.clear()
    torch.cuda.empty_cache()
    return worst


def phase_full(side: int):
    """Returns the histogram and the sweep launches of the run, its labels
    and its stats."""
    import numpy as np

    import repro_torch.core.multilevel_torch as mlt
    from repro_torch.core import buffcut_partition
    from repro_torch.core.metrics import cut_ratio, edge_cut
    from repro_torch.graphs import grid_mesh_graph
    from repro_torch.kernels import ell_histogram as eh
    from repro_torch.kernels import fennel_gain as fg
    from repro_torch.kernels import swa_attention as sw

    g = grid_mesh_graph(side)
    cfg = full_width_config()
    vcycles = []
    engine = mlt.multilevel_partition_torch

    def counted(*a, **kw):
        vcycles.append(1)
        return engine(*a, **kw)

    mlt.multilevel_partition_torch = counted
    try:
        eh.launches = sw.launches = fg.sweep_launches = 0
        block, stats = buffcut_partition(g, cfg)
        launches, swa_launches, sweeps = eh.launches, sw.launches, fg.sweep_launches
    finally:
        mlt.multilevel_partition_torch = engine
    check(block.shape == (g.n,) and bool((block >= 0).all()) and bool((block < cfg.k).all()),
          "labels outside [0, k)")
    cut = edge_cut(g, block)
    check(stats.cut_weight == cut, f"streamed cut {stats.cut_weight} != edge_cut {cut}")
    check(launches > 0, "the full-width run launched no ell_histogram kernel")
    check(sweeps == len(vcycles) > 0,
          f"{sweeps} fennel_sweep launches in {len(vcycles)} device V-cycles, expected one each")
    loads = np.bincount(block, minlength=cfg.k)
    check(loads.max() <= np.ceil(1.03 * g.n / cfg.k), "balance cap violated")
    log(f"[full] grid_mesh_graph({side}): n={g.n} m={g.m} batches={stats.n_batches} "
        f"cut_ratio={cut_ratio(g, block):.6f} balance={stats.balance:.6f} "
        f"runtime_s={stats.runtime_s:.3f} ml_time_s={stats.ml_time_s:.3f} "
        f"nodes_per_s={g.n / stats.runtime_s:.0f} ell_histogram_launches={launches} "
        f"fennel_sweep_launches={sweeps} (device V-cycles {len(vcycles)}) "
        f"swa_attention_launches={swa_launches}")
    return launches, sweeps, block, stats


def phase_profile(side: int):
    """Device time per V-cycle stage on one full-width batch: each stage
    function is wrapped with synchronized timers for this one call.
    Returns the arguments of its `_initial_fennel` call (the coarsest
    level)."""
    import torch

    import repro_torch.core.multilevel_torch as mlt
    from repro_torch.core.multilevel import multilevel_partition
    from repro_torch.graphs import grid_mesh_graph

    g = grid_mesh_graph(side)
    cfg = full_width_config()
    lo = (side // 2) * side
    model, p, loads = batch_model_case(g, lo, lo + cfg.batch_size, cfg.k, seed=3)
    stages = ("_lp_cluster", "_contract", "_initial_fennel", "_lp_refine", "_project")
    spent = {s: 0.0 for s in stages}
    calls = {s: 0 for s in stages}
    originals = {s: getattr(mlt, s) for s in stages}

    fennel_steps = []
    coarsest = []

    def wrap(name, fn):
        def timed(*a, **kw):
            if name == "_initial_fennel":  # one sequential step per free node
                fennel_steps.append(inspect.signature(fn).bind(*a, **kw).arguments["n_free"])
                coarsest.append((a, kw))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            calls[name] += 1
            return out
        return timed

    try:  # the full-width run has warmed every path
        for s in stages:
            setattr(mlt, s, wrap(s, originals[s]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        multilevel_partition(model.graph, model.pinned_block, p, loads, cfg.ml)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for s in stages:
            setattr(mlt, s, originals[s])
    parts = " ".join(f"{s.lstrip('_')}={spent[s] * 1e3:.2f}ms/{calls[s]}" for s in stages)
    log(f"[profile] one batch (n={model.graph.n}) V-cycle {total * 1e3:.2f} ms: {parts}; "
        f"initial_fennel steps (coarsest free nodes) {fennel_steps}")
    return coarsest[0]


def phase_serve() -> int:
    """h2o-danube-1.8b at full width through `serve_lm`; returns the
    swa_attention launches of that run."""
    import torch

    from repro_torch.configs.h2o_danube_1_8b import full_config
    from repro_torch.kernels import ell_histogram as eh
    from repro_torch.kernels import swa_attention as sw
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import transformer as tfm

    cfg = full_config()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params.values())
    check(n_params == cfg.param_count(), f"{n_params} parameters, config says {cfg.param_count()}")
    log(f"[serve] {cfg.name}: {n_params} parameters ({cfg.dtype}) drawn in "
        f"{time.perf_counter() - t0:.2f} s")
    eh.launches = sw.launches = 0
    res = serve_lm(cfg, SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS, device="cuda", params=params)
    launches, hist_launches = sw.launches, eh.launches
    peak = torch.cuda.max_memory_allocated()
    check(launches == cfg.n_layers * SERVE_TOKENS,
          f"{launches} swa_attention launches, expected {cfg.n_layers * SERVE_TOKENS}")
    check(bool(torch.isfinite(res.logits).all()), "serve logits are not finite")
    check(res.tokens.shape == (SERVE_BATCH, SERVE_TOKENS + 1)
          and bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()), "bad served tokens")
    log(f"[serve] batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, {SERVE_TOKENS} new tokens: "
        f"prefill {res.prefill_s:.4f} s ({SERVE_BATCH * SERVE_PROMPT / res.prefill_s:.0f} "
        f"prompt tok/s), decode {res.decode_s:.4f} s ({res.tokens_per_s:.1f} tok/s, "
        f"{res.decode_s / SERVE_TOKENS * 1e3:.3f} ms/step), peak memory {peak / 2**30:.3f} GiB, "
        f"swa_attention launches {launches}, ell_histogram launches {hist_launches}")

    # prefill's attention alone: one layer's flash_attention at the prompt's
    # shape, against the whole prefill
    from repro_torch.models.attention import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(2)
    qkv = [torch.randn((SERVE_BATCH, SERVE_PROMPT, h, cfg.d_head), generator=gen,
                       device="cuda").to(cfg.torch_dtype)
           for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flash_attention(*qkv, causal=True, window=cfg.sliding_window, q_chunk=cfg.q_chunk,
                    kv_chunk=cfg.kv_chunk)
    torch.cuda.synchronize()
    t_attn = time.perf_counter() - t0
    del qkv
    log(f"[serve] prefill attention: one layer's flash_attention {t_attn:.4f} s, x "
        f"{cfg.n_layers} layers = {t_attn * cfg.n_layers / res.prefill_s:.3f} of prefill")

    # one decode step timed, then traced, at the same cache fill (contents
    # do not change the work): the kernel's share of the step
    max_len = SERVE_PROMPT + SERVE_TOKENS + 1
    cache = tfm.init_cache(cfg, SERVE_BATCH, max_len, device="cuda")
    cache["pos"].fill_(SERVE_PROMPT + SERVE_TOKENS - 1)
    tok = torch.zeros((SERVE_BATCH, 1), dtype=torch.int32, device="cuda")
    steps = 3
    with torch.inference_mode():
        for _ in range(2):  # warm-up; every step reuses `cache`, so pos stays
            tfm.forward_decode(params, tok, cache, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            tfm.forward_decode(params, tok, cache, cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
        # one launch of the wrapper runs one kernel: its blocks compute the
        # splits, and the last block of a row merges them
        by_name = device_rows(lambda: tfm.forward_decode(params, tok, cache, cfg), steps,
                              want=SWA_KERNEL_ROW, expect=steps * cfg.n_layers)
    if by_name is None:
        log(f"[serve] one decode step at pos {SERVE_PROMPT + SERVE_TOKENS - 1}: wall {wall:.3f} "
            f"ms; device rows not measured")
    else:
        busy = sum(by_name.values())
        kernel = sum(t for k, t in by_name.items() if SWA_KERNEL_ROW in k)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        log(f"[serve] one decode step at pos {SERVE_PROMPT + SERVE_TOKENS - 1}: wall {wall:.3f} "
            f"ms, device busy {busy:.3f} ms (idle share {1 - busy / wall:.3f}), swa_attention "
            f"{kernel:.3f} ms = {kernel / busy:.3f} of device time, "
            f"{kernel / cfg.n_layers * 1e3:.2f} us per launch; top device rows: "
            + "; ".join(f"{k[:60]} {t:.3f} ms" for k, t in top))
    del params, cache, res
    torch.cuda.empty_cache()
    return launches


def phase_decode_vs_train() -> None:
    """Float32 h2o-danube-1.8b at full width: decode logits through the
    kernel, past the window, against forward_train's."""
    import numpy as np
    import torch

    from repro_torch.configs.h2o_danube_1_8b import full_config
    from repro_torch.kernels import swa_attention as sw
    from repro_torch.models import transformer as tfm

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off for this check")
    cfg = dataclasses.replace(full_config(), dtype="float32")
    prompt, steps = 4608, 4
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(1), cfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, prompt + steps)).astype(np.int32)).cuda()
    t0 = time.perf_counter()
    with torch.inference_mode():
        full = tfm.forward_train(params, toks, cfg)[:, prompt - 1:]
        logits, cache = tfm.forward_prefill(params, toks[:, :prompt], cfg, prompt + steps + 1)
        outs = [logits]
        before = sw.launches
        for i in range(steps):
            logits, cache = tfm.forward_decode(params, toks[:, prompt + i:prompt + i + 1],
                                               cache, cfg)
            outs.append(logits)
        launches = sw.launches - before
    inc = torch.cat(outs, dim=1)
    torch.cuda.synchronize()
    check(launches == cfg.n_layers * steps, f"{launches} kernel launches in {steps} steps")
    check(bool(torch.isfinite(inc).all()), "float32 decode logits are not finite")
    torch.testing.assert_close(inc, full, rtol=1e-3, atol=1e-3)
    err = float((inc - full).abs().max())
    log(f"[decode] float32 full width, prompt {prompt}, {steps} decode steps (pos past the "
        f"{cfg.sliding_window} window): decode logits == forward_train's, max_abs_err={err:g} "
        f"(|logits| max {float(full.abs().max()):.3f}), {time.perf_counter() - t0:.2f} s")
    del params, cache, full, inc, outs
    torch.cuda.empty_cache()


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """(least ms, what bounds it) at the card's byte rate and float32 rate."""
    return bound_at(bytes_moved, ops, FP32_OPS_PER_S)


def bound_at(bytes_moved: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """(least ms, what bounds it) at the card's byte rate and `ops_per_s`."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_dlrm_init():
    """dlrm-mlperf's full-width parameters, drawn on the card."""
    import torch

    from repro_torch.configs.dlrm_mlperf import full_config
    from repro_torch.models.dlrm import dlrm_init

    cfg = full_config()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = dlrm_init(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    n = params["tables"].numel() + sum(
        w.numel() for part in ("bot", "top") for key, w in params[part].items()
        if key.startswith("w"))
    check(n == cfg.param_count(), f"{n} weights, config says {cfg.param_count()}")
    log(f"[bag] {cfg.name}: {n} weights drawn on the card in {time.perf_counter() - t0:.2f} s "
        f"(tables {tuple(params['tables'].shape)}, {params['tables'].numel() * 4 / 1e9:.3f} GB)")
    return cfg, params


def bag_inputs(cfg, b: int, slots: int, seed: int, weighted: bool):
    """idx uniform over the vocabulary with a few -1 and V entries (they
    clamp), mask all ones or uniform weights."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (b, cfg.n_sparse, slots)
    idx = torch.randint(0, cfg.vocab_size, shape, generator=gen, device="cuda",
                        dtype=torch.int32)
    idx.view(-1)[::9973] = -1
    idx.view(-1)[5::10007] = cfg.vocab_size
    mask = (torch.rand(shape, generator=gen, device="cuda") if weighted
            else torch.ones(shape, device="cuda"))
    return idx, mask


def bag_bound(cfg, idx):
    """The bag's bound at these indices: each distinct (table, row) read
    once, idx and mask read, the pooled (B, T, D) rows written; one
    multiply and one add per gathered float."""
    import torch

    b, t, _ = idx.shape
    flat = idx.clamp(0, cfg.vocab_size - 1).long() + torch.arange(
        t, device="cuda")[None, :, None] * cfg.vocab_size
    rows = int(torch.unique(flat).numel())
    d = cfg.embed_dim
    return bound(rows * d * 4 + 2 * idx.numel() * 4 + b * t * d * 4, 2 * idx.numel() * d), rows


def phase_bag_kernel(cfg, params) -> dict:
    import torch
    import torch.nn.functional as F

    eb = importlib.import_module("repro_torch.kernels.embedding_bag")
    tables = params["tables"]
    t, v, d = tables.shape
    worst = 0.0
    for b in (DLRM_P99, DLRM_BULK):
        for slots in (1, 2):
            idx, mask = bag_inputs(cfg, b, slots, seed=b + slots, weighted=slots == 2)
            got = eb.embedding_bag(tables, idx, mask)
            want = eb.embedding_bag_plain(tables, idx, mask)
            torch.cuda.synchronize()
            check(got.shape == (b, t, d), f"embedding_bag shape {tuple(got.shape)}")
            err = float((got - want).abs().max())
            worst = max(worst, err)
            check(torch.equal(got, want), f"embedding_bag differs from its plain version at "
                                          f"B={b}, L={slots} (max abs err {err:g})")
            log(f"[bag] embedding_bag (B={b}, T={t}, L={slots}, V={v}, D={d}"
                f"{', weighted' if slots == 2 else ''}): equal to the plain version bit for bit")
            del got, want
    torch.cuda.empty_cache()

    timed = {}
    for b in (DLRM_P99, DLRM_BULK):
        idx, mask = bag_inputs(cfg, b, 1, seed=b, weighted=False)
        # yardstick only: one library call on the flattened (T*V, D) table
        # with offset indices (precomputed); the port never calls it
        flat_idx = (idx.clamp(0, v - 1).long()
                    + torch.arange(t, device="cuda")[None, :, None] * v).view(-1)
        offsets = torch.arange(0, idx.numel(), idx.shape[2], device="cuda")
        flat_table, flat_mask = tables.view(t * v, d), mask.view(-1)
        calls = {
            "kernel": lambda: eb.embedding_bag(tables, idx, mask),
            "plain": lambda: eb.embedding_bag_plain(tables, idx, mask),
            "F.embedding_bag": lambda: F.embedding_bag(
                flat_idx, flat_table, offsets, mode="sum", per_sample_weights=flat_mask),
        }
        torch.testing.assert_close(calls["F.embedding_bag"]().view(b, t, d), calls["kernel"](),
                                   rtol=1e-6, atol=1e-6)
        dev = {name: device_ms(fn) for name, fn in calls.items()}
        wall = {name: time_cuda(fn, iters=5 if name == "plain" else 20)
                for name, fn in calls.items()}
        # the same launch after 64 MB of writes: rows not in the 50 MB L2,
        # as for a new request (repeated launches at B=512 read from L2)
        flush = torch.empty(2**24, device="cuda")
        cold = device_ms(calls["kernel"], samples=20, reps=1, before=flush.zero_)
        del flush
        (bnd, by), rows = bag_bound(cfg, idx)
        log(f"[bag] embedding_bag B={b} L=1: kernel {dev['kernel']:.5f} ms ({cold:.5f} ms with "
            f"L2 flushed), plain {dev['plain']:.5f} ms, F.embedding_bag "
            f"{dev['F.embedding_bag']:.5f} ms (event-timed calls {wall['kernel']:.5f}, "
            f"{wall['plain']:.5f}, {wall['F.embedding_bag']:.5f} ms); bound {bnd:.5f} ms ({by}; "
            f"{rows} distinct rows of {idx.numel()} lookups)")
        timed[b] = {"ms": dev["kernel"], "plain_ms": dev["plain"],
                    "library_ms": dev["F.embedding_bag"], "bound_ms": bnd, "bound_by": by}
        del idx, mask, flat_idx, offsets, flat_mask, calls
        torch.cuda.empty_cache()
    return {
        "name": "embedding_bag",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag.py:21",
        "launches": 0,
        "max_abs_err": worst,
        **timed[DLRM_BULK],
    }


def fennel_inputs(b: int, w: int, k: int, weights: str, seed: int):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    blk = rng.integers(-1, k, (b, w)).astype(np.int32)
    wts = rng.integers(1, 6, (b, w)) if weights == "int" else rng.random((b, w))
    wts = (wts * (blk >= 0)).astype(np.float32)
    loads = (rng.random(k) * 100).astype(np.float32)  # some above FENNEL_CAP: infeasible
    node_w = rng.integers(1, 4, b).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (blk, wts, loads, node_w)]


def fennel_time(b: int, w: int, k: int, weights: str, gamma: float, profile: bool) -> dict:
    """Device times (ms) at one shape: the whole call (`device_ms`: what
    the wrapper enqueues, one launch on this tree), the same with L2 flushed
    before each call, its plain version, and the bound.  With `profile`, the
    kernel alone is also read from its profiler rows (an earlier tree's call
    also enqueued the penalty's torch ops); without, or when no trace is
    complete, the kernel's time is the call's (late in a long run profiler
    traces come back empty).  No
    single library call fuses a histogram with a masked argmax."""
    import torch

    from repro_torch.kernels import fennel_gain as fg

    args = fennel_inputs(b, w, k, weights, seed=0)
    kw = dict(alpha=FENNEL_ALPHA, gamma=gamma, cap=FENNEL_CAP)

    def call():
        return fg.fennel_choose_batch(*args, **kw)

    call_ms = device_ms(call)
    kernel = call_ms
    rows = device_rows(call, 10, want="fennel_gain", expect=10) if profile else None
    if rows is not None:
        kernel = sum(ms for key, ms in rows.items() if "fennel_gain" in key)
    flush = torch.empty(2**24, device="cuda")
    cold = device_ms(call, samples=20, reps=1, before=flush.zero_)
    del flush
    plain_ms = device_ms(lambda: fg.fennel_gain_plain(*args, **kw))
    wall = time_cuda(call)
    host = host_us(call)
    valid = int((args[0] >= 0).sum())
    # read the rows, loads and node weights once, write best and score;
    # one add per valid entry, then an add, a compare, a subtract and an
    # argmax compare per (row, block)
    bnd, by = bound(b * w * 8 + k * 4 + b * 4 + b * 8, valid + 4 * b * k)
    log(f"[fennel] fennel_gain {(b, w, k)} {weights} weights, gamma={gamma}: kernel "
        f"{kernel * 1e3:.2f} us ({'profiler rows' if rows else 'the call'}), "
        f"the call {call_ms * 1e3:.2f} us warm, {cold * 1e3:.2f} us with L2 flushed "
        f"(event-timed call {wall * 1e3:.2f} us, host time per call {host:.2f} us), plain "
        f"{plain_ms:.5f} ms; bound {bnd * 1e3:.3f} us ({by}); kernel at {bnd / kernel:.3f} of "
        f"the bound")
    return {"ms": kernel, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by}


def phase_fennel_kernel() -> dict:
    import torch

    from repro_torch.kernels import fennel_gain as fg

    for i, (b, w, k, weights) in enumerate(FENNEL_SHAPES):
        args = fennel_inputs(b, w, k, weights, seed=i)
        args[0][::5] = -1  # rows of only padding
        args[1][::5] = 0.0
        for gamma in FENNEL_GAMMAS:
            kw = dict(alpha=FENNEL_ALPHA, gamma=gamma, cap=FENNEL_CAP)
            best, score = fg.fennel_choose_batch(*args, **kw)
            want_best, want_score = fg.fennel_gain_plain(*args, **kw)
            torch.cuda.synchronize()
            check(torch.equal(best, want_best) and torch.equal(score, want_score),
                  f"fennel_gain differs from its plain version at {(b, w, k, weights, gamma)}")
        infeasible = int(torch.isneginf(score).sum())
        log(f"[fennel] fennel_gain (B={b}, W={w}, k={k}) {weights} weights, every fifth row "
            f"padding only: best and score equal to the plain version bit for bit at gamma "
            f"{', '.join(map(str, FENNEL_GAMMAS))} ({infeasible} rows with no feasible block at "
            f"the last)")
    blk, wts, _, node_w = fennel_inputs(4096, 64, 40, "int", seed=9)
    loads = torch.full((40,), 95.0, device="cuda")
    loads[[7, 30]] = 91.0
    kw = dict(alpha=FENNEL_ALPHA, gamma=1.5, cap=FENNEL_CAP)
    best, score = fg.fennel_choose_batch(blk, wts, loads, node_w, **kw)
    want = fg.fennel_gain_plain(blk, wts, loads, node_w, **kw)
    check(bool((best == 7).all()) and bool(torch.isneginf(score).all())
          and torch.equal(best, want[0]) and torch.equal(score, want[1]),
          "fennel_gain: no feasible block must give the first least-loaded block and -inf")
    log("[fennel] no feasible block: every row takes block 7 (the first least-loaded) with "
        "score -inf, as the plain version")
    b, w, k = FENNEL_LARGE_K
    args = fennel_inputs(b, w, k, "float", seed=11)
    for gamma in (1.5, 2.5):
        kw = dict(alpha=FENNEL_ALPHA, gamma=gamma, cap=FENNEL_CAP)
        got = fg.fennel_choose_batch(*args, **kw)
        want = fg.fennel_gain_plain(*args, **kw)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"fennel_gain differs from its plain version at k={k}, gamma {gamma}")
    t_large = device_ms(lambda: fg.fennel_choose_batch(*args, **kw), samples=3, reps=3)
    log(f"[fennel] fennel_gain (B={b}, W={w}, k={k}), the row in device memory: best and "
        f"score equal to the plain version bit for bit at gamma 1.5 and 2.5; {t_large:.4f} ms "
        f"a call")
    del args

    return {
        "name": "fennel_gain",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fennel_gain.cu",
        "replaces": "src/repro/kernels/fennel_gain.py:118",
        "launches": 0,
        "max_abs_err": 0.0,
        **fennel_time(*FENNEL_SHAPES[0], FENNEL_GAMMAS[1], profile=False),
        "library_ms": None,
    }


def sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def sweep_stage_ms(coarsest, reps: int = 5) -> float:
    """Median host ms of `_initial_fennel` on phase 6's coarsest level,
    synchronized: the preparation (sort, searchsorted) and the sweep."""
    import torch

    import repro_torch.core.multilevel_torch as mlt

    a, kw = coarsest
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mlt._initial_fennel(*a, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def sweep_time(coarsest, plain: bool, profile: bool) -> dict:
    """The sweep on phase 6's coarsest level: held against its plain
    version (when `plain`), and timed — the call (`device_ms`: two clones
    of labels and loads, and the launch), with `profile` the kernel alone
    (its profiler rows; without, or when no trace is complete, the kernel's
    time is the call's), and the
    whole `_initial_fennel` stage; its bounds."""
    import torch

    import repro_torch.core.multilevel_torch as mlt
    from repro_torch.kernels import fennel_gain as fg

    a, kw = coarsest
    seen = []
    sweep = mlt.fennel_sweep

    def record(*x, **y):
        seen.append((x, y))
        return sweep(*x, **y)

    mlt.fennel_sweep = record
    try:
        labels, loads = mlt._initial_fennel(*a, **kw)
    finally:
        mlt.fennel_sweep = sweep
    sa, skw = seen[0]
    node_w, order, indptr, _, loads0, n_free = sa[3:]
    out = {"plain_ms": None, "max_abs_err": 0.0}
    if plain:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want_labels, want_loads = fg.fennel_sweep_plain(*sa, **skw)
        torch.cuda.synchronize()
        out["plain_ms"] = (time.perf_counter() - t0) * 1e3
        out["max_abs_err"] = float((loads - want_loads).abs().max())
        check(torch.equal(labels, want_labels) and torch.equal(loads, want_loads),
              f"fennel_sweep differs from its plain version on the coarsest level "
              f"({int((labels != want_labels).sum())} labels, loads max abs err "
              f"{out['max_abs_err']:g})")
        log(f"[sweep] coarsest level: labels and loads equal to the plain version's bit for bit "
            f"(plain {out['plain_ms']:.2f} ms)")

    def call():
        return fg.fennel_sweep(*sa, **skw)

    call_ms = device_ms(call, samples=3, reps=3)
    kernel = call_ms
    rows = device_rows(call, 3, want="fennel_sweep", expect=3) if profile else None
    if rows is not None:
        kernel = sum(ms for key, ms in rows.items() if "fennel_sweep" in key)
    stage = sweep_stage_ms(coarsest)
    n_pad, k = node_w.shape[0], loads0.shape[0]
    seg = (indptr[order[:n_free] + 1] - indptr[order[:n_free]])
    entries = int(seg.sum())
    # each free node's segment (dst, weight), its order, indptr pair and
    # weight read once, the labels read and written, the loads; an add and
    # a compare per entry, four float64 operations per (step, block)
    bnd, by = bound_at(entries * 16 + n_free * 32 + n_pad * 16 + k * 16,
                       2 * entries + 4 * n_free * k, FP64_OPS_PER_S)
    clock = sm_clock_hz()
    chain = n_free * SWEEP_STEP_CYCLES / clock * 1e3
    log(f"[sweep] coarsest level n_pad={n_pad}, n_free={n_free}, k={k}, {entries} segment "
        f"entries (longest {int(seg.max())}): kernel {kernel:.4f} ms "
        f"({kernel / n_free * 1e6:.1f} ns a step), the call {call_ms:.4f} ms, the "
        f"_initial_fennel stage {stage:.4f} ms; bound {bnd * 1e3:.3f} us ({by}), dependent "
        f"chain {chain:.4f} ms ({SWEEP_STEP_CYCLES} cycles a step at {clock / 1e9:.3f} GHz); "
        f"kernel from {'profiler rows' if rows else 'the call'}")
    return {**out, "ms": kernel, "bound_ms": bnd, "bound_by": by}


def phase_sweep(coarsest, launches: int) -> dict:
    return {
        "name": "fennel_sweep",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fennel_gain.cu",
        "replaces": "src/repro/core/multilevel_jax.py:483",
        "replaces_kind": "jax.lax.fori_loop (_initial_fennel), not a Pallas kernel",
        "launches": launches,
        **sweep_time(coarsest, plain=True, profile=False),
        "library_ms": None,
    }


def phase_ops(cfg, params) -> dict:
    """Each public op of repro_torch.kernels once, at a main-path shape,
    with every launch count zeroed just before; returns the counts."""
    import torch

    import repro_torch.kernels as ops
    from repro_torch.kernels import ell_histogram as eh
    from repro_torch.kernels import fennel_gain as fg
    from repro_torch.kernels import swa_attention as sw

    eb = importlib.import_module("repro_torch.kernels.embedding_bag")
    hb, hw, hk = HIST_SHAPES[0]
    hist_in = hist_inputs(hb, hw, hk, seed=0, integer=True)
    gamma = FENNEL_GAMMAS[1]
    fennel_in = fennel_inputs(*FENNEL_SHAPES[0], seed=0)
    idx, mask = bag_inputs(cfg, DLRM_P99, 1, seed=3, weighted=False)
    s = SWA_SHAPES[0][1]
    swa_in = swa_inputs(SERVE_BATCH, s, 8, 4, 80, (s - 1,) * SERVE_BATCH, torch.bfloat16, seed=4)
    mods = {"ell_histogram": eh, "fennel_gain": fg, "embedding_bag": eb, "swa_attention": sw}
    for mod in mods.values():
        mod.launches = 0
    ops.block_histogram(*hist_in, hk)
    ops.fennel_choose_batch(*fennel_in, alpha=FENNEL_ALPHA, gamma=gamma, cap=FENNEL_CAP)
    ops.embedding_bag(params["tables"], idx, mask)
    ops.swa_attention_decode(*swa_in, window=4096)
    torch.cuda.synchronize()
    counts = {name: mod.launches for name, mod in mods.items()}
    check(all(n == 1 for n in counts.values()), f"public ops launched {counts}")
    log(f"[ops] repro_torch.kernels' four public ops, one call each: launches {counts}")
    return counts


def dlrm_reference_f64(cfg, params, batch, rows: int):
    """Click logits of the first `rows` samples in float64 on the CPU, from
    those rows' gathered table rows and the MLP weights (a plain forward
    written out here, independent of the port's model code); also the
    bottom MLP's output and the pooled bags."""
    import numpy as np
    import torch

    idx = batch["sparse_idx"][:rows].long().clamp(0, cfg.vocab_size - 1)
    tab = torch.arange(cfg.n_sparse)[None, :, None]
    gathered = params["tables"][tab.cuda(), idx.cuda()].cpu().double()  # (rows, T, L, D)
    pooled = (gathered * batch["sparse_mask"][:rows].double()[..., None]).sum(dim=2)

    def mlp(p, x, final_relu):
        n = len([key for key in p if key.startswith("w")])
        for i in range(n):
            x = x @ p[f"w{i}"].cpu().double() + p[f"b{i}"].cpu().double()
            if i < n - 1 or final_relu:
                x = x.clamp(min=0)
        return x

    dense_v = mlp(params["bot"], batch["dense"][:rows].cpu().double(), True)
    feats = torch.cat([dense_v[:, None, :], pooled], dim=1)
    dots = feats @ feats.transpose(1, 2)
    iu, ju = np.triu_indices(feats.shape[1], k=1)
    z = dots[:, torch.from_numpy(iu), torch.from_numpy(ju)]
    return mlp(params["top"], torch.cat([dense_v, z], dim=-1), False)[:, 0], dense_v, pooled


def phase_dlrm(cfg, params) -> int:
    """dlrm-mlperf at full width through `serve_dlrm` and `dlrm_retrieval`;
    returns the embedding_bag launches of those runs."""
    import torch

    from repro_torch.configs.dlrm_mlperf import draw_batch
    from repro_torch.launch.serve import serve_dlrm
    from repro_torch.models.dlrm import dlrm_forward, dlrm_retrieval

    eb = importlib.import_module("repro_torch.kernels.embedding_bag")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off for this check")
    table_bytes = params["tables"].numel() * 4
    launches = 0
    for name, rows in (("serve_p99", DLRM_P99), ("serve_bulk", DLRM_BULK)):
        batch = draw_batch(cfg, rows, seed=rows)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eb.launches = 0
        res = serve_dlrm(cfg, batch, DLRM_ITERS, device="cuda", params=params)
        n = eb.launches
        peak = torch.cuda.max_memory_allocated()
        check(n == res.forwards == DLRM_ITERS + 1,
              f"{n} embedding_bag launches in {res.forwards} forwards")
        launches += n
        check(res.scores.shape == (rows,) and bool(torch.isfinite(res.scores).all()),
              "serve_dlrm logits are not finite")
        want, _, _ = dlrm_reference_f64(cfg, params, batch, 64)
        got = res.scores[:64].cpu().double()
        # random weights give logits of ~1e-3, so the absolute part of the
        # tolerance scales with them
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
        log(f"[dlrm] {name}: batch {rows}, {DLRM_ITERS} timed forwards: {res.us_per_batch:.1f} "
            f"us/batch ({res.samples_per_s:.0f} samples/s), peak memory {peak / 2**30:.3f} GiB "
            f"(tables {table_bytes / 2**30:.3f} GiB), embedding_bag launches {n} in "
            f"{res.forwards} forwards; first 64 logits vs float64 on the CPU "
            f"max_abs_err={float((got - want).abs().max()):g} "
            f"(|logits| max {float(want.abs().max()):.4f})")
        if rows == DLRM_BULK:
            inputs = {key: batch[key].cuda() for key in ("dense", "sparse_idx", "sparse_mask")}
            with torch.inference_mode():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dlrm_forward(params, inputs, cfg)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                # device times from CUDA events: the forward, and the bag
                # call it makes on the same inputs
                fwd = device_ms(lambda: dlrm_forward(params, inputs, cfg), samples=3, reps=3)
                idx = inputs["sparse_idx"].to(torch.int32).contiguous()
                mask = inputs["sparse_mask"].to(torch.float32).contiguous()
                bag = device_ms(lambda: eb.embedding_bag(params["tables"], idx, mask),
                                samples=3, reps=3)
                by_name = device_rows(lambda: dlrm_forward(params, inputs, cfg), 3,
                                      want="embedding_bag_kernel", expect=3)
            log(f"[dlrm] one serve_bulk forward: wall {wall:.3f} ms, device time {fwd:.3f} ms "
                f"(events; idle share {1 - fwd / wall:.3f}), its embedding_bag call "
                f"{bag:.3f} ms = {bag / fwd:.3f} of device time")
            if by_name is not None:
                busy = sum(by_name.values())
                top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
                log(f"[dlrm] the same forward's device rows (profiler): busy {busy:.3f} ms; top "
                    f"device rows: " + "; ".join(f"{key[:60]} {ms:.3f} ms" for key, ms in top))
            del inputs, idx, mask
        del res, batch

    query = draw_batch(cfg, 1, seed=7)
    gen = torch.Generator(device="cuda").manual_seed(7)
    rbatch = {"query_dense": query["dense"].cuda(), "query_sparse_idx": query["sparse_idx"].cuda(),
              "query_sparse_mask": query["sparse_mask"].cuda(),
              "candidates": torch.randn((DLRM_CANDIDATES, cfg.embed_dim), generator=gen,
                                        device="cuda")}
    eb.launches = 0
    with torch.inference_mode():
        scores = dlrm_retrieval(params, rbatch, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DLRM_ITERS):
            scores = dlrm_retrieval(params, rbatch, cfg)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / DLRM_ITERS
    n = eb.launches
    check(n == DLRM_ITERS + 1, f"{n} embedding_bag launches in {DLRM_ITERS + 1} retrievals")
    launches += n
    check(scores.shape == (DLRM_CANDIDATES,) and bool(torch.isfinite(scores).all()),
          "retrieval scores are not finite")
    _, dense_v, pooled = dlrm_reference_f64(cfg, params, query, 1)
    user = dense_v[0] + pooled[0].mean(dim=0)
    want = rbatch["candidates"][:4096].cpu().double() @ user
    got = scores[:4096].cpu().double()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    log(f"[dlrm] retrieval_cand: one query against {DLRM_CANDIDATES} candidates "
        f"{dt * 1e6:.1f} us/query, embedding_bag launches {n}; the first 4096 scores vs "
        f"float64 max_abs_err={float((got - want).abs().max()):g}")
    del rbatch, scores
    torch.cuda.empty_cache()
    return launches


def counted_vcycles(record):
    """Context manager: wraps the device V-cycle so that every call first
    runs `record()` and appends its result to the list it yields."""
    import contextlib

    import repro_torch.core.multilevel_torch as mlt

    @contextlib.contextmanager
    def ctx():
        seen = []
        engine = mlt.multilevel_partition_torch

        def counted(*a, **kw):
            seen.append(record())
            return engine(*a, **kw)

        mlt.multilevel_partition_torch = counted
        try:
            yield seen
        finally:
            mlt.multilevel_partition_torch = engine
    return ctx()


def check_full_width(g, cfg, block, stats, launches: int, sweeps: int, vcycles: int,
                     what: str) -> None:
    """Valid labels, an exact streamed cut, the balance cap, histogram
    launches and one sweep launch per device V-cycle."""
    import numpy as np

    from repro_torch.core.metrics import edge_cut

    check(block.shape == (g.n,) and bool((block >= 0).all()) and bool((block < cfg.k).all()),
          f"{what}: labels outside [0, k)")
    cut = edge_cut(g, block)
    check(stats.cut_weight == cut, f"{what}: streamed cut {stats.cut_weight} != edge_cut {cut}")
    loads = np.bincount(block, minlength=cfg.k)
    check(loads.max() <= np.ceil((1 + cfg.eps) * g.n / cfg.k), f"{what}: balance cap violated")
    check(launches > 0, f"{what}: no ell_histogram launch")
    check(sweeps == vcycles > 0,
          f"{what}: {sweeps} fennel_sweep launches in {vcycles} device V-cycles, expected one each")


def phase_pipe(side: int, full_block, full_stats) -> None:
    """The pipelined driver at phase 5's full width (T3 runs the device
    V-cycle on a worker thread): labels bit-equal to phase 5's; then on
    phase 3's R-MAT inside a non-default stream, every V-cycle on that
    stream, and the sequential driver with prefetch_batches=2."""
    import threading

    import numpy as np
    import torch

    from repro_torch.core import (
        BuffCutConfig,
        MultilevelConfig,
        PipelineConfig,
        buffcut_partition,
        buffcut_partition_pipelined,
    )
    from repro_torch.core.metrics import cut_ratio
    from repro_torch.graphs import as_node_stream, grid_mesh_graph, rmat_graph
    from repro_torch.kernels import ell_histogram as eh
    from repro_torch.kernels import fennel_gain as fg

    g = grid_mesh_graph(side)
    cfg = full_width_config()
    main_thread = threading.get_ident()
    with counted_vcycles(threading.get_ident) as threads:
        eh.launches = fg.sweep_launches = 0
        block, stats = buffcut_partition_pipelined(g, cfg, PipelineConfig())
        launches, sweeps = eh.launches, fg.sweep_launches
    check_full_width(g, cfg, block, stats, launches, sweeps, len(threads), "pipe")
    check(np.array_equal(block, full_block), "pipelined labels differ from phase 5's")
    check(stats.cut_weight == full_stats.cut_weight and stats.balance == full_stats.balance,
          "pipelined cut or balance differs from phase 5's")
    check(main_thread not in threads, "a pipelined V-cycle ran on the calling thread")
    # the same run with T1 inline (no pump thread): what the pump costs or
    # gives T2, and whether T3's V-cycle time moves without it
    inline, inline_s = buffcut_partition_pipelined(g, cfg, PipelineConfig(prefetch_batches=0))
    check(np.array_equal(inline, full_block), "pipelined labels with prefetch 0 differ")
    # the pump's per-record resume token (inner.tell()), timed alone over
    # the whole stream: at most what its token capture takes from T2
    ns = as_node_stream(g)
    t0 = time.perf_counter()
    for _ in ns:
        pass
    t_iter = time.perf_counter() - t0
    toks = []
    t0 = time.perf_counter()
    for _ in ns:
        toks.append(ns.tell())
    t_tell = time.perf_counter() - t0 - t_iter
    del toks
    t2 = stats.runtime_s - stats.t3_wait_s
    t2_inline = inline_s.runtime_s - inline_s.t3_wait_s
    seq_loop = full_stats.runtime_s - full_stats.ml_time_s
    log(f"[pipe] grid_mesh_graph({side}), PipelineConfig() (queue 4, prefetch 2): labels == "
        f"phase 5's, cut_ratio={cut_ratio(g, block):.6f} balance={stats.balance:.6f}; "
        f"runtime_s={stats.runtime_s:.3f} (phase 5 {full_stats.runtime_s:.3f}) "
        f"ml_time_s={stats.ml_time_s:.3f} (phase 5 {full_stats.ml_time_s:.3f}) "
        f"nodes_per_s={g.n / stats.runtime_s:.0f} (phase 5 {g.n / full_stats.runtime_s:.0f}); "
        f"T2 {t2:.3f} s (runtime_s - t3_wait_s {stats.t3_wait_s:.3f}; phase 5's loop without "
        f"the V-cycle {seq_loop:.3f} s); ell_histogram_launches={launches} "
        f"fennel_sweep_launches={sweeps} on {len(set(threads))} worker thread(s), "
        f"none the caller")
    log(f"[pipe] the same with prefetch_batches=0 (T1 inline): labels == phase 5's; "
        f"runtime_s={inline_s.runtime_s:.3f} ml_time_s={inline_s.ml_time_s:.3f} T2 "
        f"{t2_inline:.3f} s (t3_wait_s {inline_s.t3_wait_s:.3f}); the pump's resume tokens "
        f"(inner.tell() per record, {g.n} records) {t_tell:.3f} s of interpreter time "
        f"(the stream alone {t_iter:.3f} s)")

    g = rmat_graph(2**16, 8, seed=0)
    dev = BuffCutConfig(k=32, buffer_size=16384, batch_size=8192,
                        ml=MultilevelConfig(engine="torch", device="cuda"))
    want, want_s = buffcut_partition(g, dev)
    s = torch.cuda.Stream()
    with counted_vcycles(lambda: (threading.get_ident(), torch.cuda.current_stream())) as seen:
        with torch.cuda.stream(s):
            got, got_s = buffcut_partition_pipelined(g, dev, PipelineConfig())
    check(len(seen) == got_s.n_batches > 0, "no V-cycle on the non-default stream run")
    check(all(tid != main_thread and cur == s for tid, cur in seen),
          "a V-cycle ran off the caller's stream or on the calling thread")
    check(np.array_equal(got, want), "pipelined labels on a side stream differ from sequential")
    pre, _ = buffcut_partition(g, dev, prefetch_batches=2)
    check(np.array_equal(pre, want), "prefetch_batches=2 changed the sequential driver's labels")
    log(f"[pipe] rmat_graph(2**16, 8), Q=16384, delta=8192 inside torch.cuda.stream(s): "
        f"{len(seen)} V-cycles on worker threads with current stream s, labels == sequential; "
        f"buffcut_partition(prefetch_batches=2) labels == prefetch_batches=0 "
        f"(runtime_s pipelined {got_s.runtime_s:.3f}, sequential {want_s.runtime_s:.3f})")


def phase_vec(side: int, full_block, full_stats) -> None:
    """The vectorized driver at phase 5's full width (wave = chunk = 32, the
    incremental VectorBuffer); then at wave = chunk = 1 on phase 3's R-MAT,
    evictions and labels equal to the sequential driver's."""
    import numpy as np

    from repro_torch.core import (
        BuffCutConfig,
        MultilevelConfig,
        VectorizedConfig,
        buffcut_partition,
        buffcut_partition_vectorized,
    )
    from repro_torch.core.metrics import cut_ratio
    from repro_torch.graphs import grid_mesh_graph, rmat_graph
    from repro_torch.kernels import ell_histogram as eh
    from repro_torch.kernels import fennel_gain as fg

    g = grid_mesh_graph(side)
    cfg = full_width_config()
    with counted_vcycles(lambda: 1) as vcycles:
        eh.launches = fg.sweep_launches = 0
        block, stats = buffcut_partition_vectorized(
            g, cfg, VectorizedConfig(wave=32, chunk=32, engine="incremental"))
        launches, sweeps = eh.launches, fg.sweep_launches
    check_full_width(g, cfg, block, stats, launches, sweeps, len(vcycles), "vec")
    log(f"[vec] grid_mesh_graph({side}), VectorizedConfig(wave=32, chunk=32, incremental): "
        f"batches={stats.n_batches} cut_ratio={cut_ratio(g, block):.6f} (phase 5 "
        f"{cut_ratio(g, full_block):.6f}) balance={stats.balance:.6f}; "
        f"runtime_s={stats.runtime_s:.3f} (phase 5 {full_stats.runtime_s:.3f}) "
        f"ml_time_s={stats.ml_time_s:.3f} (phase 5 {full_stats.ml_time_s:.3f}); "
        f"ell_histogram_launches={launches} fennel_sweep_launches={sweeps} "
        f"(device V-cycles {len(vcycles)})")

    g = rmat_graph(2**16, 8, seed=0)
    dev = BuffCutConfig(k=32, buffer_size=16384, batch_size=8192, collect_stats=True,
                        ml=MultilevelConfig(engine="torch", device="cuda"))
    want, want_s = buffcut_partition(g, dev)
    got, got_s = buffcut_partition_vectorized(g, dev, VectorizedConfig(wave=1, chunk=1))
    check(len(want_s.evictions) > 0 and [int(x) for x in got_s.evictions] == want_s.evictions,
          "wave=1 evictions differ from the sequential driver's")
    check(np.array_equal(got, want), "wave=1 labels differ from the sequential driver's")
    log(f"[vec] rmat_graph(2**16, 8), wave = chunk = 1: {len(want_s.evictions)} evictions and "
        f"labels == the sequential driver's on the device engine (runtime_s vectorized "
        f"{got_s.runtime_s:.3f}, sequential {want_s.runtime_s:.3f})")


def main(argv: list[str] | None = None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build, then time fennel_gain alone, the initial sweep on its path "
                         "(phase 6's stage split, phase 13's times) and the swa_attention "
                         "wrapper's host time; prints no result line")
    ap.add_argument("--src", type=Path, default=None,
                    help="import repro_torch from this directory instead of ./src (another "
                         "tree's kernels under the same measurements)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    if args.src is not None:
        sys.path.insert(0, str(args.src.resolve()))
    import repro_torch  # noqa: F401  (fails in a directory without the port)

    # float32 products stay float32 on every path of this run
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[env] phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    log(f"[env] repro_torch from {Path(repro_torch.__file__).parent}")
    timed("build", phase_build)
    if args.kernels_only:
        import repro_torch.core.multilevel_torch as mlt

        fennel_time(*FENNEL_SHAPES[0], FENNEL_GAMMAS[1], profile=True)
        coarsest = timed("profile", phase_profile, 1024)
        if hasattr(mlt, "fennel_sweep"):
            sweep_time(coarsest, plain=False, profile=True)
        else:  # an earlier tree: the eager step loop is the stage
            log(f"[sweep] no sweep kernel in this tree: the _initial_fennel stage "
                f"{sweep_stage_ms(coarsest, reps=1):.4f} ms")
        swa_host()
        log(f"[env] kernels only: total {time.perf_counter() - t_start:.1f} s")
        print(gpu_name_and_limit())
        return 0
    hist = timed("kernels/ell_histogram", phase_kernels)
    swa = timed("kernels/swa_attention", phase_swa_kernel)
    timed("parity", phase_parity)
    hist["max_abs_err"] = max(hist["max_abs_err"], timed("auto", phase_auto, AUTO_SIDE))
    side = 1024
    hist["launches"], sweeps, full_block, full_stats = timed("full", phase_full, side)
    coarsest = timed("profile", phase_profile, side)
    swa["launches"] = timed("serve", phase_serve)
    timed("decode", phase_decode_vs_train)
    cfg, params = timed("dlrm init", phase_dlrm_init)
    bag = timed("kernels/embedding_bag", phase_bag_kernel, cfg, params)
    fennel = timed("kernels/fennel_gain", phase_fennel_kernel)
    fennel["launches"] = timed("ops", phase_ops, cfg, params)["fennel_gain"]
    bag["launches"] = timed("dlrm", phase_dlrm, cfg, params)
    del params
    sweep = timed("sweep", phase_sweep, coarsest, sweeps)
    timed("pipe", phase_pipe, side, full_block, full_stats)
    timed("vec", phase_vec, side, full_block, full_stats)
    log(f"[env] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [hist, swa, bag, fennel, sweep]}))
    print(gpu_name_and_limit())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
