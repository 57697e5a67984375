#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. build      compile every CUDA kernel of the port from `src/repro_torch/
              kernels/csrc` with nvcc (first use, one nvcc per source, all
              at once) and print the build time and ptxas's register report;
2. kernels    hold each kernel against its plain PyTorch version on the
              card — ell_histogram: integer weights exactly, random float
              weights at rtol 1e-6 / atol 1e-5; swa_attention: at the serve
              shape with ragged pos and at edge shapes, float32 at rtol 1e-5
              / atol 1e-5 and bf16 within one bf16 ulp (rtol 8e-3 /
              atol 1e-3) — and time kernel, plain version and one library
              call computing the same function;
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
              on the largest and the last inputs the route gave it;
5. full       the BuffCut driver at full width: grid mesh 1024x1024
              (n = 2^20) with the paper's §4 settings (k=32, eps=0.03,
              Q=262144, delta=32768, HAA) on the device engine; requires
              valid labels, an exact streamed cut and histogram kernel
              launches on this path;
6. profile    per-stage time of one full-width batch V-cycle, each stage
              synchronized, and the initial partition's step count;
7. serve      `repro_torch.launch.serve.serve_lm` at h2o-danube-1.8b's
              full width (24 layers, d=2560, bf16, random weights from a
              seeded generator): batch 4, an 8192-token prompt, 32 greedy
              decode steps; requires finite logits and 24 x 32 launches of
              the swa_attention kernel; reports prefill time, decode tokens/s
              and peak memory, and profiles one decode step (the kernel's
              share of it);
8. decode     the same model in float32 with TF32 off: batch 1, a
              4608-token prompt (past the 4096 window) and 4 decode steps;
              decode logits (the kernel) must equal forward_train's (plain
              torch flash attention) at rtol 1e-3 / atol 1e-3.

The port has no host fallback: an error of a device engine fails the run.

The second-to-last lines are the kernel JSON line and the card's name and
power limit; the last line is {"ok": true, "device": {...}}.  Imports
nothing of JAX or of the JAX package `repro`.
"""
from __future__ import annotations

import dataclasses
import inspect
from collections import Counter
import json
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
# clustering-sized label domain, ragged shapes and k past one label tile
HIST_SHAPES = [(65536, 8, 32), (4096, 64, 4096), (7, 13, 4), (1, 1, 2), (64, 16, 1000)]

# the auto route's mesh: n = 33124, one batch of delta = 32768 and a tail
AUTO_SIDE = 182

# the serve phase: h2o-danube-1.8b at full width, batch 4, 8192-token prompt
SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS = 4, 8192, 32
# (B, S, KVH, G, D, window, pos): the serve path's decode shape with ragged
# pos, then pos = 0, a window wider than the cache, D = 64 and 128, G = 1
SWA_SHAPES = [
    (4, SERVE_PROMPT + SERVE_TOKENS + 1, 8, 4, 80, 4096, (8192, 5000, 4096, 37)),
    (3, 64, 8, 4, 80, 4096, (0, 0, 0)),
    (2, 100, 2, 4, 80, 4096, (100, 60)),
    (2, 300, 4, 4, 64, 128, (300, 7)),
    (2, 300, 4, 4, 128, 128, (250, 129)),
    (2, 300, 8, 1, 80, 64, (300, 1)),
]
# decode_32k of configs/lm_common.py: batch 128 against a 32768-token cache
SWA_DECODE_32K = (128, 32768)


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


def device_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Milliseconds of device work per call of `fn`: the summed device time
    of every kernel and memset it launches, from a torch.profiler trace.
    Fails if the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    check(total_us > 0, "the profiler trace holds no device time")
    return total_us / iters / 1e3


# ------------------------------------------------------------------ phases

def phase_build() -> float:
    from repro_torch.kernels import _build

    secs = _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
        log(f"[build] {name}: {_build.library_path(name).name}")
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
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
            if integer:
                check(torch.equal(got, want), f"ell_histogram integer weights differ at {(b, w, k)}")
            else:
                torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)
            log(f"[kernels] ell_histogram {(b, w, k)} "
                f"{'int' if integer else 'float'} weights: max_abs_err={err:g}")

    # times at the main path's shape (level-0 refinement of a full batch)
    b, w, k = HIST_SHAPES[0]
    blk, wts = hist_inputs(b, w, k, seed=0, integer=False)
    # yardstick only: one scatter_add_ computing the same counts (index
    # precomputed); the port never calls it
    rows = torch.arange(b, device="cuda")[:, None]
    flat = (rows * k + blk.clamp(min=0).long()).view(-1)
    wflat = wts.view(-1)
    calls = {
        "kernel": lambda: eh.block_histogram(blk, wts, k),
        "plain": lambda: eh.ell_histogram_plain(blk, wts, k),
        "scatter_add_": lambda: torch.zeros(b * k, device="cuda").scatter_add_(0, flat, wflat),
    }
    torch.testing.assert_close(eh.block_histogram(blk, wts, k),
                               calls["scatter_add_"]().view(b, k), rtol=1e-6, atol=1e-5)
    dev = {name: device_ms(fn) for name, fn in calls.items()}
    wall = {name: time_cuda(fn) for name, fn in calls.items()}
    ms, plain_ms, library_ms = dev["kernel"], dev["plain"], dev["scatter_add_"]
    for name in calls:
        log(f"[kernels] ell_histogram {(b, w, k)} {name}: device {dev[name]:.5f} ms, "
            f"event-timed call {wall[name]:.5f} ms")
    bytes_moved = b * w * 4 * 2 + b * k * 4
    ops = b * w * k + int((blk >= 0).sum())  # compares + one add per valid entry
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    log(f"[kernels] ell_histogram {(b, w, k)}: bound {max(t_bytes, t_ops) * 1e3:.3f} us "
        f"(bytes {t_bytes * 1e3:.3f} us, operations {t_ops * 1e3:.3f} us)")
    return {
        "name": "ell_histogram",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ell_histogram.cu",
        "replaces": "src/repro/kernels/ell_histogram.py:44",
        "launches": 0,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
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


def swa_time(b: int, s: int, pos, with_library: bool) -> dict:
    """Device times (ms) of the kernel, its plain version and, with
    `with_library`, one scaled_dot_product_attention call (the window as a
    boolean mask over the whole cache; a yardstick only, the port never
    calls it), bf16 at the serve path's head layout, and the kernel's
    bound.  The library call is timed at the serve shape, whose numbers
    the kernel line reports."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import swa_attention as sw

    kvh, g, d, window = 8, 4, 80, 4096
    q, k, v, p = swa_inputs(b, s, kvh, g, d, pos, torch.bfloat16, seed=b)
    j = torch.arange(s, device="cuda")
    p64 = p.long()[:, None]
    mask = ((j >= (p64 - window).clamp(min=0)) & (j < p64))[:, None, None, :]
    qh = q.view(b, kvh * g, 1, d)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, scale=1.0 / d ** 0.5,
                                              enable_gqa=True)

    calls = {
        "kernel": lambda: sw.swa_attention_decode(q, k, v, p, window=window),
        "plain": lambda: sw.swa_attention_decode_plain(q, k, v, p, window=window),
    }
    got = calls["kernel"]()
    torch.testing.assert_close(got, calls["plain"](), rtol=8e-3, atol=1e-3)
    if with_library:
        calls["sdpa"] = sdpa
        # the library's bf16 route rounds at other points than the kernel
        torch.testing.assert_close(got.view(b, kvh * g, 1, d), sdpa(), rtol=2e-2, atol=2e-3)
    del got
    dev = {name: device_ms(fn, iters=20) for name, fn in calls.items()}
    wall = time_cuda(calls["kernel"])
    bound, by = swa_bound_ms(kvh, g, d, window, s, pos, 2)
    lib = f"sdpa {dev['sdpa']:.5f} ms" if with_library else "sdpa not timed"
    log(f"[kernels] swa_attention B={b} S={s} pos={pos[0]}..{pos[-1]} bf16: kernel "
        f"{dev['kernel']:.5f} ms (event-timed call {wall:.5f} ms), plain {dev['plain']:.5f} ms, "
        f"{lib}; bound {bound:.5f} ms ({by})")
    del q, k, v, mask
    torch.cuda.empty_cache()
    return {"ms": dev["kernel"], "plain_ms": dev["plain"], "library_ms": dev.get("sdpa"),
            "bound_ms": bound, "bound_by": by}


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
            if max(pos) == 0:
                check(not bool(got.any()), "swa_attention: an empty window must give zeros")
            log(f"[kernels] swa_attention (B={b}, S={s}, KVH={kvh}, G={g}, D={d}, "
                f"window={window}, pos={pos}) {str(dtype)[6:]}: max_abs_err={err:g}")
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
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        log(f"[auto] ell_histogram {shape} from the route: max_abs_err={err:g}")
        del got, want
    inputs.clear()
    torch.cuda.empty_cache()
    return worst


def phase_full(side: int) -> int:
    import numpy as np

    from repro_torch.core import buffcut_partition
    from repro_torch.core.metrics import cut_ratio, edge_cut
    from repro_torch.graphs import grid_mesh_graph
    from repro_torch.kernels import ell_histogram as eh
    from repro_torch.kernels import swa_attention as sw

    g = grid_mesh_graph(side)
    cfg = full_width_config()
    eh.launches = sw.launches = 0
    block, stats = buffcut_partition(g, cfg)
    launches, swa_launches = eh.launches, sw.launches
    check(block.shape == (g.n,) and bool((block >= 0).all()) and bool((block < cfg.k).all()),
          "labels outside [0, k)")
    cut = edge_cut(g, block)
    check(stats.cut_weight == cut, f"streamed cut {stats.cut_weight} != edge_cut {cut}")
    check(launches > 0, "the full-width run launched no ell_histogram kernel")
    loads = np.bincount(block, minlength=cfg.k)
    check(loads.max() <= np.ceil(1.03 * g.n / cfg.k), "balance cap violated")
    log(f"[full] grid_mesh_graph({side}): n={g.n} m={g.m} batches={stats.n_batches} "
        f"cut_ratio={cut_ratio(g, block):.6f} balance={stats.balance:.6f} "
        f"runtime_s={stats.runtime_s:.3f} ml_time_s={stats.ml_time_s:.3f} "
        f"nodes_per_s={g.n / stats.runtime_s:.0f} ell_histogram_launches={launches} "
        f"swa_attention_launches={swa_launches}")
    return launches


def phase_profile(side: int) -> None:
    """Device time per V-cycle stage on one full-width batch: each stage
    function is wrapped with synchronized timers for this one call."""
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

    def wrap(name, fn):
        def timed(*a, **kw):
            if name == "_initial_fennel":  # one sequential step per free node
                fennel_steps.append(inspect.signature(fn).bind(*a, **kw).arguments["n_free"])
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


def phase_serve() -> int:
    """h2o-danube-1.8b at full width through `serve_lm`; returns the
    swa_attention launches of that run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
        # device activity only: each row is one kernel or copy, none counted twice
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                tfm.forward_decode(params, tok, cache, cfg)
            torch.cuda.synchronize()
    by_name = {e.key: e.self_device_time_total / steps / 1e3 for e in prof.key_averages()
               if e.self_device_time_total > 0}
    busy = sum(by_name.values())
    kernel = sum(t for k, t in by_name.items() if "swa_decode_kernel" in k)
    check(kernel > 0, "the profiled decode step ran no swa_attention kernel")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"[serve] one decode step at pos {SERVE_PROMPT + SERVE_TOKENS - 1}: wall {wall:.3f} ms, "
        f"device busy {busy:.3f} ms (idle share {1 - busy / wall:.3f}), swa_attention "
        f"{kernel:.3f} ms = {kernel / busy:.3f} of device time; top device rows: "
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
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

    timed("build", phase_build)
    hist = timed("kernels/ell_histogram", phase_kernels)
    swa = timed("kernels/swa_attention", phase_swa_kernel)
    timed("parity", phase_parity)
    hist["max_abs_err"] = max(hist["max_abs_err"], timed("auto", phase_auto, AUTO_SIDE))
    side = 1024
    hist["launches"] = timed("full", phase_full, side)
    timed("profile", phase_profile, side)
    swa["launches"] = timed("serve", phase_serve)
    timed("decode", phase_decode_vs_train)
    log(f"[env] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [hist, swa]}))
    print(gpu_name_and_limit())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
