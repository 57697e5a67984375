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
5. full       the BuffCut driver at full width through the front door,
              `repro_torch.api.partition(g, DriverConfig(buffcut=...,
              pipeline=PipelineConfig(prefetch_batches=0)),
              driver="buffcut")` (T1 inline, as the direct call of earlier
              versions ran): grid mesh 1024x1024 (n = 2^20) with the
              paper's §4 settings (k=32, eps=0.03, Q=262144, delta=32768,
              HAA) on the device engine; requires valid labels, an exact
              streamed cut, histogram kernel launches on this path and one
              sweep kernel launch per device V-cycle; prints the facade's
              own time (provenance runtime_s minus the driver's);
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
              then its stamped copy (`fennel_gain._sweep_stamped`, clock64()
              counters, equal labels and loads required): the decision
              warp's cycles a step by branch, the share of steps on each
              summation path, and the chain alone iterated, beside the
              chain floor of the SWEEP_STEP_CYCLES model;
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
              the sequential driver's on the device engine;
16. disk      phase 5's mesh streamed to a packed file by
              `grid_mesh_to_disk` (about 29 MB, under build/chip_smoke/),
              then `buffcut_partition_pipelined` on `DiskNodeStream(path)`
              with PipelineConfig() (prefetch 2): labels bit-equal to
              phase 5's, an exact
              streamed cut, every byte of the file read, peak resident
              bytes within the reference's bound (buffer + batch +
              read-ahead) plus the pipeline's staging, histogram launches
              and one sweep launch per V-cycle; prints runtime_s, T2,
              ml_time_s, t3_wait_s, nodes/s and the file's write time;
17. crash     a spawned child runs phase 16's disk run on the card with a
              Checkpointer every 4 batches and is SIGKILLed once the
              snapshot on disk records 16 batches or more; the parent
              resumes from that file on the card: labels bit-equal to
              phase 16's, the same cut, checkpoints_written > 0; prints
              the batch it resumed at and the resume time;
18. restream  `restream_refine` from the disk stream seeded with phase 16's
              cut and block loads, one pass in priority order and one in
              stream order: the incrementally kept cut equal to edge_cut
              on the refined labels, the balance cap, one sweep launch per
              V-cycle; prints the cut before and after, the moves, the
              seconds and the peak resident bytes;
19. shard     `shard_partition(workers=4, load_sync_every=2)` (thread
              backend) in memory on a 512x512 mesh at the full-width run's
              ratios (k = 32, Q = n/4, delta = n/32; printed as reduced):
              complete labels,
              the merged cut equal to edge_cut, block_loads equal to the
              labels' bincount, sync rounds n_batches // 2 per worker,
              histogram launches and one sweep launch per V-cycle, every
              V-cycle off the calling thread.  Then, on a 256x256 mesh at
              the full-width ratios (Q = n/4, delta = n/32: 8 batches a
              shard, as at full width; a full-width sharded run takes twice
              the sequential one, so the disk run is cut to keep the script
              in time), the same from a packed file with prefetch 2 in every
              worker (the boundary scan, the merge legs, another thread
              schedule) against the same in memory: labels, cut and loads
              equal, stream_bytes_read = split + workers + merge; one
              priority restream pass from the file seeded with the merge,
              its kept cut equal to edge_cut.  On phase 3's R-MAT: W = 4 on
              torch/cuda inside torch.cuda.stream(s) equal to W = 4 on the
              host sparse engine, every V-cycle on s off the calling thread;
              W = 1 equal to buffcut_partition;
              backend="process" refused for torch/cuda before any fork, and
              equal to the thread backend on sparse; prints runtime_s,
              split_s, pool_s, ml_time_s, the intra/cross cut and balance
              (not capped: stale loads between syncs) beside phase 5's;
20. serve partition
              a PartitionService promoted from phase 5's result by
              `PartitionResult.into_service()` (paper settings, engine
              torch; its cut and loads equal phase 5's) driven through a
              ServeSession by run_workload
              with churn_ops(updates=256, ops=1024, frac_del=0.25,
              node_adds=256, lookup_every=4, lookup_size=4096,
              refine_every=8, seed=0): 262k edge operations, 33 refines;
              the resident cut equal to edge_cut of the exported graph,
              loads equal to the labels' bincount, every lookup's labels
              equal to the service's at that point, one sweep launch per
              V-cycle, V-cycles off the calling thread; prints p50/p99 of
              each verb, updates/s, lookups/s, the cut before and after and
              the V-cycle count.  On phase 3's R-MAT the same kind of op
              list on torch/cuda, on sparse and on torch/cuda again gives
              the same labels, cut and lookup checksum;
21. api       the front door: `repro_torch.api.cli.main(["partition",
              FILE, -k 32, --buffer-size 262144, --batch-size 32768,
              --d-max 10000, --engine torch, --driver pipelined, --json
              OUT])` on phase 16's packed file: the JSON's labels bit-equal
              to phase 5's, the same cut ratio and balance, provenance
              source kind "packed", every byte read, histogram launches
              and one sweep launch per batch; HeiStream through
              `partition(g, DriverConfig(paper settings), driver=
              "heistream")` at full width: valid labels, the result's cut
              equal to edge_cut, loads within L_max, 32 sweep launches
              (one per V-cycle), its cut and runtime_s beside phase 5's;
              HeiStream on phase 3's R-MAT on torch/cuda equal to host
              sparse; and `repro_torch.launch.serve.main(["--arch",
              "partition", "--graph", "gen:grid:side=256", ...])` on the
              card;
22. gnn       the GNN path at full width: `rgg_graph(232965, seed=3)`
              (Reddit's node count; average degree ~25, cut from Reddit's
              ~492 because BuffCut's host loop pays per edge) in
              `random_order(., 1)`; `place_graph(g, 8, method="buffcut")`
              on the card (scaled_config: Q = 29,120, delta = 7,280; engine
              auto: the host V-cycle with the histogram kernel) with labels
              bit-equal to `place_graph(..., device="cpu")`'s (the host
              sparse engine), histogram launches on the path, the cut
              equal to edge_cut and loads within L_max; `placement_report`
              of the four methods on the host (BuffCut's halo below
              random's; it and the host placement run in a spawned
              process beside the card's) and `reorder_for_shards`
              shard-major; then
              graphsage-reddit's full_config (d_in 602, d_hidden 128, 41
              classes, fanout 25-10) trained 20 steps with AdamW(lr=1e-2,
              warmup_steps=5) on batches of 1024 seeds sampled with
              `sample_multihop(..., block_of=placement.block)`, features
              (n x 602 float32) resident on the card and gathered there,
              labels block % 41: every loss finite, the last below the
              first, the first step's loss and gradient norm equal to the
              CPU's at rtol 1e-4; prints the sampler's ms a step, a step's
              device ms (CUDA events behind a spin), wall ms, idle share
              and peak memory; then `build_training` of egnn, meshgraphnet
              and schnet at `--preset full` on the card through `TrainLoop`
              for 10 steps, a checkpoint every 5 and one injected fault
              (retries == 1, finite losses, the first equal to the CPU's at
              rtol 1e-4).  Its histogram launches join the kernels line;
23. moe_serve moonshot-v1-16b-a3b at full width and depth (48 layers,
              28,888,467,456 parameters, 57.78 GB bf16, drawn on the card a
              block of rows at a time) through `serve_lm`: batch 4, a
              1024-token prompt, 32 greedy steps; finite logits, tokens in
              range; prefill time, decode tok/s, ms a step against the
              step's byte bound (every expert is read at T = 4), peak
              memory, and how many experts received a token in each layer
              at prefill; then stablelm-3b at full depth and llama4-scout
              and command-r-plus cut to 8 layers (printed as reduced), each
              at batch 4, a 256-token prompt and 8 steps, each freed before
              the next;
24. moe_parity moonshot at full width, 2 of 48 layers, float32, TF32 off:
              prefill and 4 decode steps on the card and on the CPU from
              the same weights, logits equal at rtol / atol 1e-3; one MoE
              layer with its router's odd columns copies of the even ones:
              slots, token ids and keep equal on both (ties to the lower
              expert); the layer run twice on the card, bit-equal;
25. train_lm  h2o-danube-1.8b at full width and depth through
              `build_training(..., "full", 8, 128)`, `make_train_step` and
              `TrainLoop` for 20 steps: finite losses, the last below the
              first; a step's wall time, device time (profiler rows), idle
              share, tokens/s and peak memory; then moonshot at full width
              and 2 of 48 layers for 10 steps (the MoE backward); for both,
              the first loss at 2 layers in float32 on the card equal to
              the CPU's at rtol 1e-4;
26. train_dlrm dlrm-mlperf at full width with 2^18 rows a table (printed as
              reduced), 20 steps through `TrainLoop` at batch 4096: finite
              losses, the first equal to the CPU's at rtol 1e-4, and 0
              embedding_bag launches (the loss pools through the plain
              bag).  Phases 23-26 launch no kernel of the port: the kernels
              line adds their counts (0) to each kernel's;
27. mesh      the device mesh on a world of one (NCCL, from a FileStore in
              a temporary directory) through the cells' own step functions
              (`repro_torch.launch.steps.build_cell` / `step_cell`, on
              DTensors placed by the sharding rules): h2o-danube-1.8b's
              prefill_32k and decode_32k cells at full width (batch 4, a
              1024-token prompt, 8 decode steps; reduced, printed) with the
              logits and the cache bit-equal to plain forward_prefill /
              forward_decode and 8 x 24 swa_attention launches from the
              decode cell; moonshot at full width and 2 of 48 layers
              through the prefill_32k cell with the expert-parallel MoE
              (two all-to-alls) bit-equal to the one-device MoE;
              dlrm-mlperf's serve_p99 and retrieval_cand cells at full
              width bit-equal to dlrm_forward / dlrm_retrieval, one
              embedding_bag launch each on the tables' local shard;
              graphsage-reddit's minibatch_lg train cell for 5 steps
              against make_train_step's (loss and gradient norm at rtol
              1e-5: index_add's float atomics); `sage_fullgraph_halo_loss`
              and its gradients on phase 22's BuffCut placement in
              shard-major order against `sage_loss` on the assembled graph
              (float32: the loss at rtol 1e-5 and the gradients' difference
              beside sage_loss's own from a rerun, float atomics; float64:
              every gradient entry at rtol 1e-5), with the frontier's size
              and the rank count; each
              beside its plain function's time.  Meanwhile, in two
              subprocesses (the fake group is process-wide), the dry-run of
              stablelm-3b train_4k and dlrm-mlperf serve_p99 on a fake 16x16
              mesh: per-rank peak bytes, collective bytes, flops and the
              bottleneck under an H100's published peaks.  Its launches
              join the kernels line;
28. quickstart `examples/quickstart_torch.py` as a user runs it (a child
              process, no device flag, so on the card): exit 0, its five
              quality lines, `device=cuda (5 runs)` (every result's
              provenance) and OK; then its buffcut run at the same SOURCE
              and OPTS in process (engine auto on cuda: the host V-cycle
              with the histogram kernel) with labels and cut bit-equal to
              host `sparse`, histogram launches on the path (added to the
              kernels line) and the kernel equal to its plain version on
              the largest input the run gave it; `python -m repro_torch
              analyze --format json` (exit 0, 0 new); and the cold import
              of `repro_torch.api` and `repro_torch.api.cli` in fresh
              interpreters (torch absent from sys.modules after each) beside
              `import torch`'s.

To stay inside the time limit with phase 27, two repeats that the bench
should own were cut: phase 16 runs the disk stream at prefetch 2 only (the
prefetch-0 run repeated it to compare depths), and phase 19's in-memory
W = 4 run is on a 512x512 mesh (at 1024^2 it took 63-91 s, the sequential
driver's time).  Every path is still driven and every kernel still held
against its plain version.

Phase 2 also runs swa_attention's general paths (G = 32, D = 36 in bf16, a
strided q with an int64 pos) and phase 10 fennel_gain at k = 65,536 (the
row in device memory), each against its plain version; the latter is
timed beside its bound.

Kernel times are device times from CUDA events around calls enqueued
behind a spin kernel (`device_ms`); `--kernels-only` also reads the kernel
alone from its rows in a profiler trace (`device_rows`), which an earlier
tree's fennel_gain call needs (it enqueued torch ops beside the kernel).
Profiler traces late in a long run can come back incomplete; no check
rests on them, and the rows of such a run are logged as not measured.

`--kernels-only` builds and runs only the timings of the fennel_gain kernel
(phase 10's) and of the initial sweep on its path (phase 6's stage split,
then phase 13's times and counters), the swa_attention wrapper's host time
per call at the serve shape and decode_32k, fennel_gain at k = 65,536 and
swa_attention's general paths timed beside their bounds; it prints no
result line.  With `--src OTHER/src` (an earlier commit unpacked with `git
archive` into a directory `.gitignore` lists) it also builds OTHER's
`repro_torch/kernels/csrc/fennel_gain.cu` with this tree's nvcc flags,
holds its sweep's labels and loads equal to this tree's on phase 13's
level, and times the two sweep kernels in turns on the same inputs
(other, this, this, other), then phase 6's batch V-cycle and its
`_initial_fennel` stage in turns with the sweep routed to each.

The port has no host fallback: an error of a device engine fails the run.

The second-to-last lines are the kernel JSON line and the card's name and
power limit; the last line is {"ok": true, "device": {...}}.  Imports
nothing of JAX or of the JAX package `repro`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import inspect
from collections import Counter
import json
import re
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published peaks of one H100 SXM (NVIDIA data sheet), for bound_ms
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12  # dense, on the tensor cores

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
# the sweep's dependent chain a step (k <= 32), a floor: each lane holds
# its block's two scores for the step, for whether the block took the step
# before or not, so a step waits only on the step before's choice, through
# the compare of the lane with it and the select of a key's high word
# (ISETP, SEL), the lane packed below the key's top 27 bits (LOP3), two
# independent reduxes of that word (REDUX.MAX and the move of its uniform
# result; the second issues behind the first) and the lane read back (LOP3,
# IADD).  Cycles of each link on an H100 SXM, read as dependent chains of
# those instructions in a loop (an integer op ~9); the stamped sweep
# iterates the chain itself beside it ("chain alone")
SWEEP_CHAIN_SELECT, SWEEP_CHAIN_REDUX, SWEEP_CHAIN_INT = 18, 46, 9
SWEEP_STEP_CYCLES = SWEEP_CHAIN_SELECT + SWEEP_CHAIN_INT + SWEEP_CHAIN_REDUX + 2 * SWEEP_CHAIN_INT
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
    the output written once; 4·G·D operations per valid position (the two
    products) at the rate of the units that run them: bf16 at the widths of
    swa_split_mma_kernel (D = 64, 80 or 128) on the tensor cores, any other
    shape in float32 on the CUDA cores."""
    n = sum(max(0, min(p, s) - max(p - window, 0)) for p in pos)
    b = len(pos)
    bytes_moved = 2 * n * kvh * d * itemsize + 2 * b * kvh * g * d * itemsize + 4 * b
    rate = BF16_TENSOR_OPS_PER_S if itemsize == 2 and d in (64, 80, 128) else FP32_OPS_PER_S
    return bound_at(bytes_moved, 4 * n * kvh * g * d, rate)


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


def swa_general_time() -> None:
    """The wrapper's general paths (SWA_GENERAL) timed on the card: the
    call (every launch it makes) and its plain version, beside the bound
    from the shape."""
    import torch

    from repro_torch.kernels import swa_attention as sw

    for i, (b, s, kvh, g, d, window, pos, dtype) in enumerate(SWA_GENERAL):
        dt = getattr(torch, dtype)
        q, k, v, p = swa_inputs(b, s, kvh, g, d, pos, dt, seed=50 + i)
        call = device_ms(lambda: sw.swa_attention_decode(q, k, v, p, window=window))
        plain = device_ms(lambda: sw.swa_attention_decode_plain(q, k, v, p, window=window))
        bnd, by = swa_bound_ms(kvh, g, d, window, s, pos, dt.itemsize)
        log(f"[kernels] swa_attention general path (B={b}, S={s}, KVH={kvh}, G={g}, D={d}, "
            f"window={window}, pos={pos}) {dtype}: the call {call:.5f} ms "
            f"({-(-g // 16)} launch(es)), plain {plain:.5f} ms; bound {bnd:.5f} ms ({by}), "
            f"the call at {bnd / call:.4f} of it")
        del q, k, v, p
    torch.cuda.empty_cache()


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


@contextlib.contextmanager
def recording_histogram(inputs: dict, shapes: list):
    """Record every `block_histogram` call of the host V-cycle: its (B, W,
    k) into `shapes`, the first inputs of each shape into `inputs`.  The
    host V-cycle imports the wrapper from its module at each call
    (`core/histogram.py::label_histogram_ell`), so the module's attribute
    is the one to wrap."""
    import repro_torch.core.multilevel_torch  # noqa: F401  (binds the real wrapper first)
    from repro_torch.kernels import ell_histogram as eh

    wrapper = eh.block_histogram

    def recording(nbr_blk, nbr_w, k):
        shapes.append((*nbr_blk.shape, int(k)))
        inputs.setdefault(shapes[-1], (nbr_blk, nbr_w))
        return wrapper(nbr_blk, nbr_w, k)

    eh.block_histogram = recording
    try:
        yield
    finally:
        eh.block_histogram = wrapper


def phase_auto(side: int) -> float:
    """The default engine through the driver at the paper's settings, held
    against the host `sparse` engine; returns the kernel's largest error
    against its plain version on the inputs this route gave it."""
    import numpy as np
    import torch

    from repro_torch.core import MultilevelConfig, buffcut_partition
    from repro_torch.graphs import grid_mesh_graph
    from repro_torch.kernels import ell_histogram as eh

    g = grid_mesh_graph(side)
    cfg = dataclasses.replace(full_width_config(), ml=MultilevelConfig())
    check(cfg.ml.engine == "auto" and cfg.ml.device == "cuda", "the default engine moved")
    inputs, shapes = {}, []  # (B, W, k) -> the first inputs of that shape
    with recording_histogram(inputs, shapes):
        eh.launches = 0
        block, stats = buffcut_partition(g, cfg)
        launches = eh.launches
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
    """The sequential driver at full width through the front door,
    `repro_torch.api.partition`.  Returns the histogram and the sweep
    launches of the run, its labels, its stats and the `PartitionResult`."""
    import numpy as np

    import repro_torch.core.multilevel_torch as mlt
    from repro_torch.api import DriverConfig, partition
    from repro_torch.core.metrics import cut_ratio, edge_cut
    from repro_torch.core.pipeline import PipelineConfig
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
        # prefetch 0 (T1 inline), as earlier versions of this script ran it
        dc = DriverConfig(buffcut=cfg, pipeline=PipelineConfig(prefetch_batches=0))
        res = partition(g, dc, driver="buffcut")
        launches, swa_launches, sweeps = eh.launches, sw.launches, fg.sweep_launches
    finally:
        mlt.multilevel_partition_torch = engine
    block, stats = res.labels, res.stats
    check(res.provenance["driver"] == "buffcut" and res.provenance["device"] == "cuda"
          and res.provenance["config"]["pipeline"]["prefetch_batches"] == 0,
          f"the API ran {res.provenance['driver']} on {res.provenance['device']}")
    check(block.shape == (g.n,) and bool((block >= 0).all()) and bool((block < cfg.k).all()),
          "labels outside [0, k)")
    cut = edge_cut(g, block)
    check(stats.cut_weight == cut, f"streamed cut {stats.cut_weight} != edge_cut {cut}")
    check(launches > 0, "the full-width run launched no ell_histogram kernel")
    check(sweeps == len(vcycles) > 0,
          f"{sweeps} fennel_sweep launches in {len(vcycles)} device V-cycles, expected one each")
    loads = np.bincount(block, minlength=cfg.k)
    check(loads.max() <= np.ceil(1.03 * g.n / cfg.k), "balance cap violated")
    check(res.cut_weight == cut and res.balance == stats.balance,
          "the result's metrics differ from the run's")
    prov_s = res.provenance["runtime_s"]
    log(f"[full] repro_torch.api.partition(grid_mesh_graph({side}), DriverConfig(paper "
        f"settings, engine torch), driver='buffcut') (prefetch_batches="
        f"{res.provenance['config']['pipeline']['prefetch_batches']}): n={g.n} m={g.m} "
        f"batches={stats.n_batches} cut_ratio={cut_ratio(g, block):.6f} "
        f"balance={stats.balance:.6f} runtime_s={stats.runtime_s:.3f} "
        f"ml_time_s={stats.ml_time_s:.3f} nodes_per_s={g.n / stats.runtime_s:.0f} "
        f"provenance runtime_s={prov_s:.3f} (facade {prov_s - stats.runtime_s:.3f} s) "
        f"ell_histogram_launches={launches} fennel_sweep_launches={sweeps} (device V-cycles "
        f"{len(vcycles)}) swa_attention_launches={swa_launches}")
    return launches, sweeps, block, stats, res


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
    bnd, by = fennel_bound(args, b, w, k)
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
    fennel_large_k()

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


def fennel_bound(args, b: int, w: int, k: int) -> tuple[float, str]:
    """The rows, loads and node weights read once, best and score written
    once; one add per valid entry, then an add, a compare, a subtract and
    an argmax compare per (row, block)."""
    valid = int((args[0] >= 0).sum())
    return bound(b * w * 8 + k * 4 + b * 4 + b * 8, valid + 4 * b * k)


def fennel_large_k() -> None:
    """The public op past shared memory (the row in device memory): bit for
    bit against its plain version at two gammas, and its call timed beside
    its bound."""
    import torch

    from repro_torch.kernels import fennel_gain as fg

    b, w, k = FENNEL_LARGE_K
    args = fennel_inputs(b, w, k, "float", seed=11)
    for gamma in (1.5, 2.5):
        kw = dict(alpha=FENNEL_ALPHA, gamma=gamma, cap=FENNEL_CAP)
        got = fg.fennel_choose_batch(*args, **kw)
        want = fg.fennel_gain_plain(*args, **kw)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"fennel_gain differs from its plain version at k={k}, gamma {gamma}")
    t_large = device_ms(lambda: fg.fennel_choose_batch(*args, **kw), samples=3, reps=3)
    bnd, by = fennel_bound(args, b, w, k)
    log(f"[fennel] fennel_gain (B={b}, W={w}, k={k}), the row in device memory: best and "
        f"score equal to the plain version bit for bit at gamma 1.5 and 2.5; {t_large:.4f} ms "
        f"a call; bound {bnd * 1e3:.3f} us ({by}), the call at {bnd / t_large:.5f} of it")
    del args
    torch.cuda.empty_cache()


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


def other_sweep(src: Path):
    """`fennel_sweep` as another tree would run it: that tree's
    `fennel_gain.cu` (`src` is the tree's `src`), built with this tree's
    nvcc flags into build/other_sweep/ and launched as this tree's wrapper
    launches its own (the C entry point is the same)."""
    import ctypes
    import hashlib

    from repro_torch.kernels import _build
    from repro_torch.kernels import fennel_gain as fg

    cu = Path(src) / "repro_torch" / "kernels" / "csrc" / "fennel_gain.cu"
    digest = hashlib.sha256(cu.read_bytes()).hexdigest()[:16]
    out = ROOT / "build" / "other_sweep" / f"fennel_gain-{digest}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    if not out.exists():
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(cu)],
                       check=True, capture_output=True, text=True, timeout=600)
    fn = ctypes.CDLL(str(out)).fennel_sweep_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    log(f"[sweep] other tree's kernel: {cu} -> {out.name}")

    def sweep(esrc, edst, ew, node_w, order, indptr, labels0, loads0, n_free, *, alpha, gamma,
              cap, w_c):
        labels, loads, err = fg._launch_sweep(fn, edst, ew, node_w, order, indptr, labels0,
                                              loads0, n_free, alpha, gamma, cap)
        check(err == 0, f"the other tree's sweep launch failed with CUDA error {err}")
        return labels, loads

    return sweep


def sweep_turns(other, coarsest) -> None:
    """Phase 6's batch V-cycle (median of 3 after a warm-up) and its
    `_initial_fennel` stage, timed in turns (other, this, this, other) with
    `fennel_sweep` routed to `other` (an `other_sweep`) on its turns; the
    V-cycle's labels must be equal on both."""
    import numpy as np
    import torch

    import repro_torch.core.multilevel_torch as mlt
    from repro_torch.core.multilevel import multilevel_partition
    from repro_torch.graphs import grid_mesh_graph

    side = 1024
    g = grid_mesh_graph(side)
    cfg = full_width_config()
    lo = (side // 2) * side
    model, p, loads = batch_model_case(g, lo, lo + cfg.batch_size, cfg.k, seed=3)
    this = mlt.fennel_sweep

    def vcycle():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels = multilevel_partition(model.graph, model.pinned_block, p, loads, cfg.ml)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, np.asarray(labels)

    turns = []
    try:
        for name, fn in (("other", other), ("this", this), ("this", this), ("other", other)):
            mlt.fennel_sweep = fn
            vcycle()
            runs = [vcycle() for _ in range(3)]
            turns.append((name, sorted(ms for ms, _ in runs)[1], sweep_stage_ms(coarsest),
                          runs[0][1]))
    finally:
        mlt.fennel_sweep = this
    check(all(np.array_equal(t[3], turns[0][3]) for t in turns),
          "the V-cycle's labels differ between the two trees' sweep kernels")
    log("[sweep] phase 6's batch V-cycle and the _initial_fennel stage in turns, labels equal: "
        + ", ".join(f"{name} {ms:.2f} ms / {stage:.4f} ms" for name, ms, stage, _ in turns))


def sweep_stamps(sa, skw, labels, loads, clock: float) -> dict:
    """The stamped copy of the sweep kernel on the sweep's arguments: its
    labels and loads must equal the kernel's; logs the decision warp's
    cycles a step by branch, the steps on each summation path, and the
    chain alone against the SWEEP_STEP_CYCLES model."""
    import torch

    from repro_torch.kernels import fennel_gain as fg

    got_labels, got_loads, st = fg._sweep_stamped(
        *sa, alpha=skw["alpha"], gamma=skw["gamma"], cap=skw["cap"])
    check(torch.equal(got_labels, labels) and torch.equal(got_loads, loads),
          "the stamped sweep differs from the sweep kernel")
    n = st["steps"]
    cyc = {key[:-7]: st[key] / n for key in fg.STAMP_KEYS if key.endswith("_cycles")
           and key != "chain_cycles"}
    chain = st["chain_cycles"] / st["chain_reps"]
    fast = n - st["long_steps"] - st["direct_steps"] - st["ordered_steps"] - st["exact_steps"]
    share = {"exact, with the step before's node": st["exact_steps"], "no patch": fast,
             "ordered, fractional": st["ordered_steps"], "long (9-1024)": st["long_steps"],
             "direct (>1024)": st["direct_steps"]}
    log(f"[sweep] stamped copy (labels and loads equal to the kernel's): cycles a step "
        f"{', '.join(f'{k_} {v:.1f}' for k_, v in cyc.items())}; steps {n}: settled on full "
        f"keys {st['settle_steps']}, no feasible block {st['fallback_steps']}; waits on the "
        f"stager {st['waits']}")
    log(f"[sweep] summation paths: "
        + ", ".join(f"{k_} {v} ({100 * v / n:.2f}%)" for k_, v in share.items()))
    log(f"[sweep] chain alone {chain:.1f} cycles a step ({chain / clock * 1e9:.1f} ns at "
        f"{clock / 1e9:.3f} GHz); model SWEEP_STEP_CYCLES = {SWEEP_CHAIN_SELECT} + "
        f"{SWEEP_CHAIN_INT} + {SWEEP_CHAIN_REDUX} + 2 x {SWEEP_CHAIN_INT} = {SWEEP_STEP_CYCLES} cycles "
        f"({SWEEP_STEP_CYCLES / clock * 1e9:.1f} ns), {n * SWEEP_STEP_CYCLES / clock * 1e3:.4f} "
        f"ms for {n} steps")
    return {**st, "chain_cycles_a_step": chain}


def sweep_time(coarsest, plain: bool, profile: bool, other=None) -> dict:
    """The sweep on phase 6's coarsest level: held against its plain
    version (when `plain`), and timed — the call (`device_ms`: two clones
    of labels and loads, and the launch), with `profile` the kernel alone
    (its profiler rows; without, or when no trace is complete, the kernel's
    time is the call's), and the
    whole `_initial_fennel` stage; its bounds; its stamped copy's counters.
    `other` (an `other_sweep`) is held equal and timed in turns with this
    tree's kernel."""
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
    if other is not None:

        def other_call():
            return other(*sa, **skw)

        o_labels, o_loads = other_call()
        check(torch.equal(o_labels, labels) and torch.equal(o_loads, loads),
              "the other tree's sweep differs from this tree's on the coarsest level")
        turns = [("other", other_call), ("this", call), ("this", call), ("other", other_call)]
        times = [(name, device_ms(fn, samples=3, reps=3)) for name, fn in turns]
        log("[sweep] in turns on one card, labels and loads equal: " + ", ".join(
            f"{name} {ms:.4f} ms ({ms / n_free * 1e6:.1f} ns a step)" for name, ms in times))
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
    sweep_stamps(sa, skw, labels, loads, clock)
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


# the out-of-core phases: files under a directory of the checkout that
# .gitignore lists; phase 17's cadence and kill point, in batches
OOC_DIR = ROOT / "build" / "chip_smoke"
CRASH_EVERY, CRASH_AT = 4, 16


def pipe_resident_bound(stream, cfg, pipe, max_deg: int) -> int:
    """tests/test_stream_conformance.py::_resident_bound (buffer + batch +
    read-ahead, every retained node at the adjacency cache's dtypes) plus
    the pipelined driver's staging: the prefetch pump's blocks (int32 ids,
    float32 weights, 64 bytes a record) and the batch payloads queued for
    or held by T3."""
    per_node = max_deg * 16 + 96
    retained = (cfg.buffer_size + 2 * cfg.batch_size + 2) * per_node
    read_ahead = 2 * stream.io_chunk_bytes + per_node
    staged = ((pipe.prefetch_batches + 1) * cfg.batch_size * (max_deg * 8 + 64)
              + (pipe.queue_depth + 1) * cfg.batch_size * per_node)
    return retained + read_ahead + staged


def phase_disk(side: int, full_block, full_stats):
    """Phase 5's mesh from a packed file through the pipelined driver at
    prefetch 2.  Returns the file's path and, by depth, the labels, the
    stats and the histogram and sweep launches."""
    import os

    import numpy as np

    from repro_torch.core import PipelineConfig, buffcut_partition_pipelined
    from repro_torch.graphs import DiskNodeStream, grid_mesh_graph, grid_mesh_to_disk
    from repro_torch.kernels import ell_histogram as eh
    from repro_torch.kernels import fennel_gain as fg

    OOC_DIR.mkdir(parents=True, exist_ok=True)
    path = str(OOC_DIR / f"grid{side}.bcsr")
    t0 = time.perf_counter()
    grid_mesh_to_disk(side, path)
    t_write = time.perf_counter() - t0
    size = os.path.getsize(path)
    g = grid_mesh_graph(side)
    cfg = full_width_config()
    log(f"[disk] grid_mesh_to_disk({side}): n={g.n} m={g.m}, {size} bytes written in "
        f"{t_write:.3f} s (one record at a time)")
    runs = {}
    for depth in (2,):  # prefetch 0 against 2 is the bench's question, not the smoke's
        pipe = PipelineConfig(prefetch_batches=depth)
        stream = DiskNodeStream(path)
        with counted_vcycles(lambda: 1) as vcycles:
            eh.launches = fg.sweep_launches = 0
            block, stats = buffcut_partition_pipelined(stream, cfg, pipe)
            launches, sweeps = eh.launches, fg.sweep_launches
        what = f"disk, prefetch {depth}"
        check_full_width(g, cfg, block, stats, launches, sweeps, len(vcycles), what)
        check(np.array_equal(block, full_block), f"{what}: labels differ from phase 5's")
        check(stats.cut_weight == full_stats.cut_weight and stats.balance == full_stats.balance,
              f"{what}: cut or balance differs from phase 5's")
        check(stats.stream_bytes_read >= size - 64,
              f"{what}: read {stats.stream_bytes_read} of the file's {size} bytes")
        bnd = pipe_resident_bound(stream, cfg, pipe, int(g.max_degree))
        check(stats.peak_resident_bytes <= bnd,
              f"{what}: peak resident {stats.peak_resident_bytes} bytes over the bound {bnd}")
        t2 = stats.runtime_s - stats.t3_wait_s
        log(f"[disk] DiskNodeStream, PipelineConfig(prefetch_batches={depth}): labels == "
            f"phase 5's, cut={stats.cut_weight:.0f} balance={stats.balance:.6f}; "
            f"runtime_s={stats.runtime_s:.3f} T2 {t2:.3f} s ml_time_s={stats.ml_time_s:.3f} "
            f"t3_wait_s={stats.t3_wait_s:.3f} nodes_per_s={g.n / stats.runtime_s:.0f} "
            f"(phase 5 in memory: runtime_s {full_stats.runtime_s:.3f}); "
            f"stream_bytes_read={stats.stream_bytes_read} peak_resident_bytes="
            f"{stats.peak_resident_bytes} (bound {bnd}); ell_histogram_launches={launches} "
            f"fennel_sweep_launches={sweeps} (device V-cycles {len(vcycles)})")
        runs[depth] = (block, stats, launches, sweeps)
    return path, runs


def crash_child(src: str, path: str, ckpt_path: str, cfg_json: str, every: int) -> None:
    """Phase 17's child, started with the spawn method (a CUDA context does
    not survive a fork): phase 16's disk run, snapshotting every `every`
    batches until the parent kills it."""
    sys.path.insert(0, src)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core import (
        BuffCutConfig,
        Checkpointer,
        PipelineConfig,
        buffcut_partition_pipelined,
    )
    from repro_torch.graphs import DiskNodeStream

    buffcut_partition_pipelined(DiskNodeStream(path), BuffCutConfig.from_json(cfg_json),
                                PipelineConfig(), ckpt=Checkpointer(ckpt_path, every=every))


def phase_crash(path: str, want_block, want_stats) -> tuple[int, int]:
    """SIGKILL a checkpointing child mid-run, resume from its snapshot on
    the card; returns the resumed run's histogram and sweep launches."""
    import multiprocessing
    import os
    import signal

    import numpy as np

    import repro_torch
    from repro_torch.core import PipelineConfig, buffcut_partition_pipelined, load_checkpoint
    from repro_torch.graphs import DiskNodeStream
    from repro_torch.kernels import ell_histogram as eh
    from repro_torch.kernels import fennel_gain as fg

    ckpt_path = str(OOC_DIR / "crash.ckpt")
    for stale in (ckpt_path, ckpt_path + ".tmp"):
        if os.path.exists(stale):
            os.remove(stale)
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    cfg = full_width_config()
    child = multiprocessing.get_context("spawn").Process(
        target=crash_child, args=(src, path, ckpt_path, cfg.to_json(), CRASH_EVERY),
        name="chip-smoke-crash-child")
    t0 = time.perf_counter()
    child.start()
    seen = None
    batches = 0
    try:
        deadline = time.monotonic() + 600
        while batches < CRASH_AT:
            check(time.monotonic() < deadline, "no snapshot of enough batches in 600 s")
            if os.path.exists(ckpt_path) and os.stat(ckpt_path).st_mtime_ns != seen:
                seen = os.stat(ckpt_path).st_mtime_ns
                batches = int(load_checkpoint(ckpt_path)["stats"]["n_batches"])
                continue
            check(child.is_alive(), f"the child ended (exit code {child.exitcode}) before a "
                                    f"snapshot of {CRASH_AT} batches")
            time.sleep(0.2)
        os.kill(child.pid, signal.SIGKILL)
    finally:
        if child.is_alive():
            child.kill()
        child.join(timeout=60)
    t_kill = time.perf_counter() - t0
    check(child.exitcode == -signal.SIGKILL, f"the child exited with {child.exitcode}, "
                                             "not by SIGKILL")
    t0 = time.perf_counter()
    state = load_checkpoint(ckpt_path)
    t_load = time.perf_counter() - t0
    at = int(state["stats"]["n_batches"])
    check(at >= CRASH_AT, f"the snapshot on disk records {at} batches")
    t0 = time.perf_counter()
    with counted_vcycles(lambda: 1) as vcycles:
        eh.launches = fg.sweep_launches = 0
        block, stats = buffcut_partition_pipelined(DiskNodeStream(path), cfg, PipelineConfig(),
                                                   resume=state)
        launches, sweeps = eh.launches, fg.sweep_launches
    t_resume = time.perf_counter() - t0
    check(np.array_equal(block, want_block), "resumed labels differ from phase 16's")
    check(stats.cut_weight == want_stats.cut_weight and stats.balance == want_stats.balance,
          "resumed cut or balance differs from phase 16's")
    check(stats.checkpoints_written > 0, "the resumed run counts no checkpoint")
    check(stats.n_batches == want_stats.n_batches, "the resumed run's batch count differs")
    check(launches > 0 and sweeps == len(vcycles) == stats.n_batches - at,
          f"resume: {sweeps} fennel_sweep launches in {len(vcycles)} V-cycles for "
          f"{stats.n_batches - at} batches")
    log(f"[crash] spawned child SIGKILLed {t_kill:.3f} s after its start, its snapshot on disk "
        f"at batch {at} of {want_stats.n_batches} (record {state['pos']['index']}, byte offset "
        f"{state['pos']['offset']}, {os.path.getsize(ckpt_path)} bytes, loaded in "
        f"{t_load:.3f} s); resumed on the card in {t_resume:.3f} s (runtime_s "
        f"{stats.runtime_s:.3f} with the first run's {state['stats']['runtime_s']:.3f}): labels "
        f"== phase 16's, cut={stats.cut_weight:.0f}, checkpoints_written="
        f"{stats.checkpoints_written}; ell_histogram_launches={launches} "
        f"fennel_sweep_launches={sweeps}")
    os.remove(ckpt_path)
    return launches, sweeps


def phase_restream(path: str, side: int, block, stats) -> tuple[int, int]:
    """One restream pass from the disk stream in each order, seeded with
    phase 16's cut and loads; returns the histogram and sweep launches."""
    import numpy as np

    from repro_torch.core import edge_cut, restream_refine
    from repro_torch.graphs import DiskNodeStream, grid_mesh_graph
    from repro_torch.kernels import ell_histogram as eh
    from repro_torch.kernels import fennel_gain as fg

    g = grid_mesh_graph(side)
    cfg = full_width_config()
    total = [0, 0]
    for order in ("priority", "stream"):
        with counted_vcycles(lambda: 1) as vcycles:
            eh.launches = fg.sweep_launches = 0
            t0 = time.perf_counter()
            refined, info = restream_refine(DiskNodeStream(path), block, cfg, 1, order=order,
                                            initial_cut=stats.cut_weight,
                                            initial_loads=np.asarray(stats.block_loads))
            secs = time.perf_counter() - t0
            launches, sweeps = eh.launches, fg.sweep_launches
        log_ = info.passes[0]
        cut = edge_cut(g, refined)
        check(info.cut_weight == cut,
              f"restream {order}: kept cut {info.cut_weight} != edge_cut {cut}")
        loads = np.bincount(refined, minlength=cfg.k)
        check(bool((refined >= 0).all()) and loads.max() <= np.ceil((1 + cfg.eps) * g.n / cfg.k),
              f"restream {order}: balance cap violated")
        check(launches > 0, f"restream {order}: no ell_histogram launch")
        check(sweeps == len(vcycles) == log_["n_batches"] > 0,
              f"restream {order}: {sweeps} fennel_sweep launches in {len(vcycles)} V-cycles "
              f"for {log_['n_batches']} batches")
        log(f"[restream] restream_refine order={order}, 1 pass from DiskNodeStream: cut "
            f"{log_['cut_before']:.0f} -> {log_['cut_after']:.0f} (== edge_cut), moved="
            f"{log_['moved']} batches={log_['n_batches']} hubs={log_['n_hubs']}, "
            f"{secs:.3f} s, balance={info.balance:.6f}, peak_resident_bytes="
            f"{info.peak_resident_bytes}, stream_bytes_read={info.stream_bytes_read}; "
            f"ell_histogram_launches={launches} fennel_sweep_launches={sweeps}")
        total[0] += launches
        total[1] += sweeps
    return total[0], total[1]


def rmat_config(engine: str = "torch"):
    """Phase 3's R-MAT settings: k = 32, Q = 16384, delta = 8192."""
    from repro_torch.core import BuffCutConfig, MultilevelConfig

    device = "cpu" if engine == "sparse" else "cuda"
    return BuffCutConfig(k=32, buffer_size=16384, batch_size=8192,
                         ml=MultilevelConfig(engine=engine, device=device))


def check_merged(g, cfg, block, stats, info, what: str) -> None:
    """Complete labels, the merged cut equal to edge_cut, block_loads
    equal to the bincount of the labels, intra + cross == cut."""
    import numpy as np

    from repro_torch.core.metrics import edge_cut

    check(block.shape == (g.n,) and bool((block >= 0).all()) and bool((block < cfg.k).all()),
          f"{what}: labels incomplete or outside [0, k)")
    cut = edge_cut(g, block)
    check(stats.cut_weight == cut, f"{what}: merged cut {stats.cut_weight} != edge_cut {cut}")
    loads = np.bincount(block, minlength=cfg.k).astype(np.float64)
    check(np.array_equal(np.asarray(stats.block_loads), loads),
          f"{what}: block_loads differ from the bincount of the labels")
    check(info["cut_intra_shard"] + info["cut_cross_shard"] == stats.cut_weight,
          f"{what}: intra + cross != the merged cut")


def ratio_config(side: int):
    """Phase 5's settings scaled to a side x side mesh at the full-width
    run's ratios: k = 32, Q = n/4, delta = n/32 (so each of 4 shards holds
    8 batches, as at full width)."""
    n = side * side
    return dataclasses.replace(full_width_config(), buffer_size=n // 4, batch_size=n // 32)


def phase_shard(side: int, full_stats):
    """The sharded driver (W = 4 threads) at phase 5's full width in
    memory; then disk against memory on a SHARD_DISK_SIDE mesh at the
    full-width ratios and one reconciliation restream pass; on phase 3's
    R-MAT the engine, W = 1, stream and backend checks.  Returns the
    full-width run's (histogram, sweep) launches, the disk run's and the
    restream's."""
    import multiprocessing

    import numpy as np
    import torch

    from repro_torch.core import buffcut_partition, edge_cut, restream_refine
    from repro_torch.distributed import ShardPool, shard_partition
    from repro_torch.graphs import DiskNodeStream, grid_mesh_graph, grid_mesh_to_disk, rmat_graph
    from repro_torch.kernels import ell_histogram as eh
    from repro_torch.kernels import fennel_gain as fg

    # W = 4 on a SHARD_SIDE mesh at the full-width run's ratios (at 1024^2 it
    # took 63-91 s, the sequential driver's time: the four host loops share
    # one interpreter lock)
    g = grid_mesh_graph(SHARD_SIDE)
    cfg = ratio_config(SHARD_SIDE)
    main_thread = threading.get_ident()
    with counted_vcycles(threading.get_ident) as threads:
        eh.launches = fg.sweep_launches = 0
        block, stats, info = shard_partition(g, cfg, workers=4, load_sync_every=2,
                                             backend="thread")
        launches, sweeps = eh.launches, fg.sweep_launches
    check_merged(g, cfg, block, stats, info, "shard, memory")
    per = info["per_worker"]
    check(info["sync_rounds"] == [p["n_batches"] // 2 for p in per],
          f"shard: sync rounds {info['sync_rounds']} for batches {[p['n_batches'] for p in per]}")
    check(launches > 0, "shard: no ell_histogram launch")
    check(sweeps == len(threads) == stats.n_batches > 0,
          f"shard: {sweeps} fennel_sweep launches in {len(threads)} device V-cycles for "
          f"{stats.n_batches} batches")
    check(main_thread not in threads, "shard: a V-cycle ran on the calling thread")
    log(f"[shard] grid_mesh_graph({SHARD_SIDE}) (reduced from {side}: k=32, Q="
        f"{cfg.buffer_size}, delta={cfg.batch_size}, the full-width ratios), "
        f"shard_partition(workers=4, load_sync_every=2, thread): batches={stats.n_batches} "
        f"({[p['n_batches'] for p in per]}), sync_rounds={info['sync_rounds']}; "
        f"runtime_s={stats.runtime_s:.3f} split_s={info['split_s']:.3f} "
        f"pool_s={info['pool_s']:.3f} ml_time_s={stats.ml_time_s:.3f} (summed over workers) "
        f"cut={stats.cut_weight:.0f} (== edge_cut; intra-shard {info['cut_intra_shard']:.0f}, "
        f"cross-shard {info['cut_cross_shard']:.0f}) balance={stats.balance:.6f}; "
        f"ell_histogram_launches={launches} fennel_sweep_launches={sweeps} on "
        f"{len(set(threads))} worker threads, none the caller")

    # disk against memory, on a smaller mesh at the full-width ratios (a
    # full-width sharded run takes 2x the sequential one: the four host
    # loops share one interpreter lock): the boundary scan and the merge
    # legs, with prefetch 2 in every worker (another thread schedule)
    dside = SHARD_DISK_SIDE
    dg, dcfg = grid_mesh_graph(dside), ratio_config(dside)
    OOC_DIR.mkdir(parents=True, exist_ok=True)
    path = str(OOC_DIR / f"grid{dside}.bcsr")
    grid_mesh_to_disk(dside, path)
    mblock, mstats, minfo = shard_partition(dg, dcfg, workers=4, load_sync_every=2)
    check_merged(dg, dcfg, mblock, mstats, minfo, "shard, small mesh in memory")
    with counted_vcycles(lambda: 1) as vcycles:
        eh.launches = fg.sweep_launches = 0
        dblock, dstats, dinfo = shard_partition(DiskNodeStream(path), dcfg, workers=4,
                                                load_sync_every=2, prefetch_batches=2)
        dlaunches, dsweeps = eh.launches, fg.sweep_launches
    check_merged(dg, dcfg, dblock, dstats, dinfo, "shard, disk")
    check(np.array_equal(dblock, mblock), "shard: disk labels differ from memory's")
    check(dstats.cut_weight == mstats.cut_weight and dstats.block_loads == mstats.block_loads,
          "shard: disk cut or loads differ from memory's")
    check(dinfo["sync_rounds"] == minfo["sync_rounds"] == [4, 4, 4, 4],
          f"shard, disk: sync rounds {dinfo['sync_rounds']}")
    worker_bytes = sum(p["stream_bytes_read"] for p in dinfo["per_worker"])
    check(dstats.stream_bytes_read == dinfo["split_bytes"] + worker_bytes + dinfo["merge_bytes"],
          "shard, disk: stream_bytes_read is not split + workers + merge")
    check(dsweeps == len(vcycles) == dstats.n_batches and dlaunches > 0,
          f"shard, disk: {dsweeps} fennel_sweep launches in {len(vcycles)} V-cycles")
    log(f"[shard] grid_mesh_to_disk({dside}) (n={dg.n}, k=32, Q={dcfg.buffer_size}, "
        f"delta={dcfg.batch_size}), W=4, load_sync_every=2: DiskNodeStream with "
        f"prefetch_batches=2 in each worker == in memory (labels, cut {dstats.cut_weight:.0f}, "
        f"loads; sync_rounds {dinfo['sync_rounds']}); runtime_s disk {dstats.runtime_s:.3f} "
        f"(split_s {dinfo['split_s']:.3f}, pool_s {dinfo['pool_s']:.3f}), memory "
        f"{mstats.runtime_s:.3f}; balance={dstats.balance:.6f}; stream_bytes_read="
        f"{dstats.stream_bytes_read} (split {dinfo['split_bytes']} + workers {worker_bytes} + "
        f"merge {dinfo['merge_bytes']}) peak_resident_bytes={dstats.peak_resident_bytes}; "
        f"ell_histogram_launches={dlaunches} fennel_sweep_launches={dsweeps}")

    # reconciliation: one priority restream pass from the file, seeded
    # with the disk run's merge
    with counted_vcycles(lambda: 1) as vcycles:
        eh.launches = fg.sweep_launches = 0
        t0 = time.perf_counter()
        refined, rinfo = restream_refine(DiskNodeStream(path), dblock, dcfg, 1,
                                         order="priority", initial_cut=dstats.cut_weight,
                                         initial_loads=np.asarray(dstats.block_loads))
        secs = time.perf_counter() - t0
        rlaunches, rsweeps = eh.launches, fg.sweep_launches
    Path(path).unlink()
    rcut = edge_cut(dg, refined)
    check(rinfo.cut_weight == rcut, f"reconcile: kept cut {rinfo.cut_weight} != edge_cut {rcut}")
    check(rsweeps == len(vcycles) == rinfo.passes[0]["n_batches"] > 0,
          f"reconcile: {rsweeps} fennel_sweep launches in {len(vcycles)} V-cycles")
    log(f"[shard] reconcile: restream_refine(order=priority, 1 pass) from the file, seeded "
        f"with the merged labels, cut and loads: cut {rinfo.passes[0]['cut_before']:.0f} -> "
        f"{rinfo.cut_weight:.0f} (== edge_cut), moved={rinfo.passes[0]['moved']}, {secs:.3f} s, "
        f"balance={rinfo.balance:.6f}; ell_histogram_launches={rlaunches} "
        f"fennel_sweep_launches={rsweeps}")

    # phase 3's R-MAT: torch == sparse, W = 1 == the driver, a side stream,
    # the process backend
    rg = rmat_graph(2**16, 8, seed=0)
    dev, host = rmat_config("torch"), rmat_config("sparse")
    t0 = time.perf_counter()
    want, want_s, _ = shard_partition(rg, host, workers=4, load_sync_every=2)
    t_host = time.perf_counter() - t0
    s = torch.cuda.Stream()
    with counted_vcycles(lambda: (threading.get_ident(), torch.cuda.current_stream())) as seen:
        with torch.cuda.stream(s):
            got, got_s, _ = shard_partition(rg, dev, workers=4, load_sync_every=2)
    check(np.array_equal(got, want) and got_s.cut_weight == want_s.cut_weight,
          "shard on R-MAT: torch/cuda labels differ from sparse")
    check(len(seen) == got_s.n_batches > 0 and
          all(tid != main_thread and cur == s for tid, cur in seen),
          "shard on R-MAT: a V-cycle ran off the caller's stream or on the calling thread")
    one, one_s, _ = shard_partition(rg, dev, workers=1)
    seq, seq_s = buffcut_partition(rg, dev)
    check(np.array_equal(one, seq) and one_s.cut_weight == seq_s.cut_weight,
          "shard on R-MAT: W = 1 differs from buffcut_partition")
    start = ShardPool.start

    def forked(self):
        raise AssertionError("the pool started")

    ShardPool.start = forked
    try:
        try:
            shard_partition(rg, dev, workers=4, backend="process")
            refused = ""
        except ValueError as e:
            refused = str(e)
    finally:
        ShardPool.start = start
    check("fork" in refused and not multiprocessing.active_children(),
          "shard: backend='process' with torch on cuda was not refused before a fork")
    t0 = time.perf_counter()
    proc, proc_s, _ = shard_partition(rg, host, workers=4, load_sync_every=2, backend="process")
    t_proc = time.perf_counter() - t0
    check(np.array_equal(proc, want) and proc_s.block_loads == want_s.block_loads,
          "shard on R-MAT: process backend differs from thread backend (sparse)")
    check(not multiprocessing.active_children(), "shard: a forked worker outlived its run")
    log(f"[shard] rmat_graph(2**16, 8), k=32, Q=16384, delta=8192, W=4, load_sync_every=2: "
        f"torch/cuda inside torch.cuda.stream(s) == sparse (cut {got_s.cut_weight:.0f}, "
        f"{len(seen)} V-cycles on worker threads with current stream s); "
        f"W=1 == buffcut_partition; "
        f"backend='process' refused for torch/cuda before a fork (\"{refused[:60]}...\"); "
        f"process == thread on sparse (process {t_proc:.2f} s, thread {t_host:.2f} s, "
        f"torch/cuda {got_s.runtime_s:.2f} s)")
    return (launches, sweeps), (dlaunches, dsweeps), (rlaunches, rsweeps)


# phase 19's disk-against-memory mesh (n = 65,536, at the full-width ratios)
SHARD_SIDE, SHARD_DISK_SIDE = 512, 256

# phase 20's workload: 256 updates of 1024 edge ops, a lookup of 4096
# nodes after every 4th, a refine after every 8th
SERVE_CHURN = dict(updates=256, ops=1024, frac_del=0.25, node_adds=256, lookup_every=4,
                   lookup_size=4096, refine_every=8, seed=0)


class LookupRecorder:
    """`run_workload`'s target: forwards every verb to a `ServeSession`;
    keeps each lookup's nodes and answer, and before each refine a copy of
    the service's labels (labels change only in refines, and node adds
    append), so every answer is checked after the run against the labels
    it was given under."""

    def __init__(self, sess):
        self.sess = sess
        self.answers = []   # (nodes, labels returned, index of the snapshot that holds)
        self.snaps = []

    def lookup(self, nodes):
        out = self.sess.lookup(nodes)
        self.answers.append((nodes, out, len(self.snaps)))
        return out

    def update(self, **kw):
        return self.sess.update(**kw)

    def refine(self, budget=None):
        self.snaps.append(self.sess.service.labels)
        return self.sess.refine(budget)

    def verify(self) -> int:
        """Number of answers checked; fails the run on any mismatch."""
        self.snaps.append(self.sess.service.labels)
        import numpy as np

        for i, (nodes, out, snap) in enumerate(self.answers):
            check(np.array_equal(out, self.snaps[snap][nodes]),
                  f"serve: lookup {i}'s labels differ from the service's at that point")
        return len(self.answers)


def serve_run(svc, ops):
    """`svc` (a PartitionService) driven through a ServeSession by
    run_workload; returns (service, report, recorder, V-cycle threads)."""
    from repro_torch.serve import ServeSession, run_workload

    with counted_vcycles(threading.get_ident) as threads:
        with ServeSession(svc) as sess:
            rec = LookupRecorder(sess)
            report = run_workload(rec, ops)
    return svc, report, rec, threads


def phase_serve_partition(side: int, full_res):
    """The partition service promoted from phase 5's result
    (`PartitionResult.into_service`) under 262k churn operations (engine
    torch on the card), then on phase 3's R-MAT the same op list on torch
    and on sparse.  Returns the histogram and sweep launches of the mesh
    run."""
    import numpy as np

    from repro_torch.core import buffcut_partition, edge_cut
    from repro_torch.graphs import rmat_graph
    from repro_torch.kernels import ell_histogram as eh
    from repro_torch.kernels import fennel_gain as fg
    from repro_torch.serve import ChurnSpec, PartitionService, churn_ops

    full_stats = full_res.stats
    g = full_res.graph
    cfg = full_width_config()
    t0 = time.perf_counter()
    ops = churn_ops(g, ChurnSpec(**SERVE_CHURN))
    t_gen = time.perf_counter() - t0
    n_edge_ops = sum(len(p["insert_edges"] or ()) + len(p["delete_edges"] or ())
                     for k, p in ops if k == "update")
    t0 = time.perf_counter()
    svc0 = full_res.into_service()
    t_promote = time.perf_counter() - t0
    check(svc0.cut_weight == full_stats.cut_weight, "into_service: cut differs from phase 5's")
    check(np.array_equal(svc0.block_loads, np.asarray(full_stats.block_loads)),
          "into_service: loads differ from phase 5's")
    check(svc0.cfg.to_json() == cfg.to_json(), "into_service: config differs from phase 5's")
    eh.launches = fg.sweep_launches = 0
    svc, rep, rec, threads = serve_run(svc0, ops)
    launches, sweeps = eh.launches, fg.sweep_launches
    checked = rec.verify()
    t0 = time.perf_counter()
    cut = edge_cut(svc.export_graph(), svc.labels)
    t_check = time.perf_counter() - t0
    check(svc.cut_weight == cut, f"serve: resident cut {svc.cut_weight} != edge_cut {cut}")
    loads = np.bincount(svc.labels, minlength=cfg.k).astype(np.float64)
    check(np.array_equal(svc.block_loads, loads), "serve: loads differ from the labels' bincount")
    refines = svc.counters["refines"]
    check(sweeps == len(threads) > 0 and launches > 0,
          f"serve: {sweeps} fennel_sweep launches in {len(threads)} device V-cycles")
    check(threading.get_ident() not in threads, "serve: a V-cycle ran on the calling thread")
    cut0 = full_stats.cut_weight
    log(f"[serve] PartitionService from phase 5's result (into_service, {t_promote:.3f} s) "
        f"on grid_mesh_graph({side}), paper "
        f"settings, engine torch, through a ServeSession by run_workload: churn_ops("
        f"{SERVE_CHURN}) made {len(ops)} ops ({n_edge_ops} edge ops) in {t_gen:.3f} s; "
        f"lookup p50/p99 {rep['lookup']['p50_ms']:.3f}/{rep['lookup']['p99_ms']:.3f} ms, "
        f"update p50/p99 {rep['update']['p50_ms']:.3f}/{rep['update']['p99_ms']:.3f} ms, "
        f"refine p50/p99 {rep['refine']['p50_ms']:.3f}/{rep['refine']['p99_ms']:.3f} ms "
        f"({rep['refine']['count']} refines, each with the recorder's copy of the labels); "
        f"updates_per_s={rep['update']['updates_per_s']:.0f} "
        f"lookups_per_s={rep['lookup']['lookups_per_s']:.0f} (nodes); cut {cut0:.0f} -> "
        f"{svc.cut_weight:.0f} (== edge_cut of the exported graph, {t_check:.3f} s), "
        f"balance={svc.balance:.6f}, n={svc.n} m={svc.m}; {checked} lookups equal the labels "
        f"they were served under (checksum {rep['lookup_checksum']}); refines={refines} "
        f"redecided={svc.counters['redecided']} V-cycles={len(threads)} on "
        f"{len(set(threads))} worker thread(s); ell_histogram_launches={launches} "
        f"fennel_sweep_launches={sweeps}")

    rg = rmat_graph(2**16, 8, seed=0)
    labels, _ = buffcut_partition(rg, rmat_config("sparse"))
    rops = churn_ops(rg, ChurnSpec(updates=64, ops=256, frac_del=0.25, node_adds=64,
                                   lookup_every=4, lookup_size=1024, refine_every=8, seed=0))
    runs = [serve_run(PartitionService(rg, labels, rmat_config(e)), rops)
            for e in ("torch", "sparse", "torch")]
    for svc_, rep_, rec_, _ in runs:
        rec_.verify()
    (a, ra, _, va), (b, rb, _, _), (c, _, _, _) = runs
    check(np.array_equal(a.labels, b.labels) and a.cut_weight == b.cut_weight
          and ra["lookup_checksum"] == rb["lookup_checksum"],
          "serve on R-MAT: torch/cuda labels differ from sparse")
    check(np.array_equal(a.labels, c.labels), "serve on R-MAT: two torch runs differ")
    check(a.cut_weight == edge_cut(a.export_graph(), a.labels), "serve on R-MAT: cut not exact")
    log(f"[serve] rmat_graph(2**16, 8), k=32, Q=16384, delta=8192, {len(rops)} ops: torch/cuda "
        f"== sparse == torch/cuda again (labels, cut {a.cut_weight:.0f}, checksum); "
        f"{len(va)} V-cycles; refine p50 torch {ra['refine']['p50_ms']:.3f} ms, sparse "
        f"{rb['refine']['p50_ms']:.3f} ms")
    return launches, sweeps


def phase_api(path: str, side: int, full_res) -> dict:
    """Phase 21, the front door: (a) `python -m repro_torch partition`'s
    `main` with the pipelined driver on phase 16's packed file, its JSON
    labels bit-equal to phase 5's; (b) HeiStream through the API at full
    width on the card (one sweep launch per V-cycle), and on phase 3's
    R-MAT equal to the host `sparse` engine; (c) the serve CLI's
    `--arch partition` on the card.  Returns the launches of (a) and (b)."""
    import contextlib
    import io
    import os

    import numpy as np

    from repro_torch.api import DriverConfig, partition
    from repro_torch.api.cli import main as cli_main
    from repro_torch.core.metrics import edge_cut
    from repro_torch.graphs import rmat_graph
    from repro_torch.kernels import ell_histogram as eh
    from repro_torch.kernels import fennel_gain as fg
    from repro_torch.launch import serve

    full_block, full_stats = full_res.labels, full_res.stats
    g = full_res.graph
    size = os.path.getsize(path)
    out = str(OOC_DIR / "api_partition.json")
    cfg = full_width_config()  # phase 5's settings as CLI flags
    argv = ["partition", path, "-k", str(cfg.k), "--buffer-size", str(cfg.buffer_size),
            "--batch-size", str(cfg.batch_size), "--d-max", f"{cfg.d_max:g}", "--engine",
            cfg.ml.engine, "--driver", "pipelined", "--json", out]
    eh.launches = fg.sweep_launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as said:
        rc = cli_main(argv)
    t_cli = time.perf_counter() - t0
    cli = {"ell_histogram": eh.launches, "fennel_sweep": fg.sweep_launches}
    check(rc == 0, f"api: the CLI exited with {rc}")
    with open(out) as f:
        blob = json.load(f)
    os.remove(out)
    prov, st = blob["provenance"], blob["stats"]
    check(np.array_equal(np.asarray(blob["labels"], dtype=np.int64), full_block),
          "api: the CLI's JSON labels differ from phase 5's")
    check(blob["metrics"]["cut_ratio"] == full_res.cut_ratio
          and blob["metrics"]["balance"] == full_res.balance,
          "api: the CLI's cut ratio or balance differs from phase 5's")
    check(st["cut_weight"] == full_stats.cut_weight, "api: the CLI's cut differs from phase 5's")
    check(prov["source"]["kind"] == "packed" and prov["driver"] == "buffcut-pipe"
          and prov["device"] == "cuda" and prov["engine"] == "torch",
          f"api: provenance {prov['source']['kind']}, {prov['driver']}, {prov['device']}")
    check(st["stream_bytes_read"] >= size - 64,
          f"api: read {st['stream_bytes_read']} of the file's {size} bytes")
    check(cli["ell_histogram"] > 0 and cli["fennel_sweep"] == st["n_batches"] > 0,
          f"api: CLI launches {cli}, {st['n_batches']} batches")
    log(f"[api] python -m repro_torch {' '.join(argv[:-2])} (phase 16's file, {size} bytes): "
        f"exit 0 in {t_cli:.3f} s; {said.getvalue().strip().splitlines()[0]}; JSON labels == "
        f"phase 5's, cut={st['cut_weight']:.0f} balance={st['balance']:.6f}, "
        f"runtime_s={st['runtime_s']:.3f} T2 {st['runtime_s'] - st['t3_wait_s']:.3f} s "
        f"ml_time_s={st['ml_time_s']:.3f} provenance runtime_s={prov['runtime_s']:.3f} "
        f"(facade {prov['runtime_s'] - st['runtime_s']:.3f} s), stream_bytes_read="
        f"{st['stream_bytes_read']}; ell_histogram_launches={cli['ell_histogram']} "
        f"fennel_sweep_launches={cli['fennel_sweep']}")

    with counted_vcycles(lambda: 1) as vcycles:
        eh.launches = fg.sweep_launches = 0
        hs = partition(g, DriverConfig(buffcut=cfg), driver="heistream")
        hei = {"ell_histogram": eh.launches, "fennel_sweep": fg.sweep_launches}
    labels = hs.labels
    check(labels.shape == (g.n,) and bool((labels >= 0).all()) and bool((labels < cfg.k).all()),
          "heistream: labels outside [0, k)")
    cut = edge_cut(g, labels)
    check(hs.cut_weight == cut, f"heistream: cut {hs.cut_weight} != edge_cut {cut}")
    loads = np.bincount(labels, minlength=cfg.k)
    check(loads.max() <= np.ceil((1 + cfg.eps) * g.n / cfg.k),
          f"heistream: balance {hs.balance} over the cap L_max")
    check(hei["fennel_sweep"] == len(vcycles) == hs.stats.n_batches == 32,
          f"heistream: {hei['fennel_sweep']} sweep launches in {len(vcycles)} V-cycles, "
          f"{hs.stats.n_batches} batches (expected 32)")
    check(hei["ell_histogram"] > 0, "heistream: no ell_histogram launch")
    prov_s = hs.provenance["runtime_s"]
    log(f"[api] partition(grid_mesh_graph({side}), paper settings, engine torch, "
        f"driver='heistream'): batches={hs.stats.n_batches} cut={cut:.0f} "
        f"cut_ratio={hs.cut_ratio:.6f} balance={hs.balance:.6f} runtime_s="
        f"{hs.stats.runtime_s:.3f} ml_time_s={hs.stats.ml_time_s:.3f} provenance runtime_s="
        f"{prov_s:.3f} (facade {prov_s - hs.stats.runtime_s:.3f} s); phase 5 (BuffCut): "
        f"cut={full_stats.cut_weight:.0f} runtime_s={full_stats.runtime_s:.3f}; "
        f"ell_histogram_launches={hei['ell_histogram']} fennel_sweep_launches="
        f"{hei['fennel_sweep']} (device V-cycles {len(vcycles)})")

    rg = rmat_graph(2**16, 8, seed=0)
    rk = dict(k=32, buffer_size=16384, batch_size=8192, driver="heistream")
    dev = partition(rg, engine="torch", device="cuda", **rk)
    host = partition(rg, engine="sparse", device="cpu", **rk)
    check(np.array_equal(dev.labels, host.labels) and dev.cut_weight == host.cut_weight,
          "heistream on R-MAT: torch/cuda labels differ from the host sparse engine's")
    log(f"[api] heistream on rmat_graph(2**16, 8), k=32, delta=8192: torch/cuda == sparse "
        f"(labels, cut {dev.cut_weight:.0f}); runtime_s torch {dev.stats.runtime_s:.3f} s, "
        f"sparse {host.stats.runtime_s:.3f} s")

    sargs = ["--arch", "partition", "--graph", "gen:grid:side=256", "--k", "32", "--batch",
             "4096", "--queries", "64"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as said:
        serve.main(sargs)
    line = said.getvalue().strip()
    check(line.startswith("partition serve: driver=buffcut device=cuda n=65536 k=32 "),
          f"api: serve --arch partition printed {line!r}")
    log(f"[api] python -m repro_torch.launch.serve {' '.join(sargs)}: "
        f"{time.perf_counter() - t0:.3f} s; {line}")
    return {"cli": cli, "heistream": hei}


# ------------------------------------------------------------ the GNN path

# Reddit's node count (configs/gnn_common.py), 8 data shards, the full-width
# GraphSAGE's training steps, and the other archs' steps through TrainLoop
GNN_NODES, GNN_SHARDS, GNN_STEPS, GNN_LOOP_STEPS = 232_965, 8, 20, 10


def gnn_loop_run(arch: str) -> None:
    """`build_training(arch, "full")` on the card through `TrainLoop` for
    GNN_LOOP_STEPS steps, a checkpoint every 5, one injected fault at step
    7 (restored from step 5); its first loss against the CPU's."""
    import math
    import shutil

    from repro_torch.launch.train import build_training
    from repro_torch.train import AdamW, CheckpointManager, LoopConfig, TrainLoop, make_train_step

    ckpt_dir = OOC_DIR / f"gnn_ckpt_{arch}"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    _, params, loss, data = build_training(arch, "full", device="cuda")
    # the optimizer `python -m repro_torch.launch.train --steps 10` builds
    opt = AdamW(lr=3e-4, warmup_steps=GNN_LOOP_STEPS // 10 + 1)
    faults = []

    def hook(step: int) -> None:
        if step == 7 and not faults:
            faults.append(step)
            raise RuntimeError("injected node failure")

    loop = TrainLoop(make_train_step(loss, opt), CheckpointManager(str(ckpt_dir)),
                     LoopConfig(total_steps=GNN_LOOP_STEPS, checkpoint_every=5),
                     fault_hook=hook)
    t0 = time.perf_counter()
    (_, state), hist = loop.run(params, opt.init(params), data)
    dt = time.perf_counter() - t0
    steps_kept = loop.ckpt.all_steps()
    check(loop.retries == 1 and faults == [7], f"{arch}: retries {loop.retries}, faults {faults}")
    check(len(hist) == GNN_LOOP_STEPS + 2 and int(state.count) == GNN_LOOP_STEPS
          and steps_kept == [5, 10],
          f"{arch}: {len(hist)} losses, count {int(state.count)}, checkpoints {steps_kept}")
    check(all(math.isfinite(x) for x in hist), f"{arch}: a loss is not finite: {hist}")
    _, cpu_params, cpu_loss, cpu_data = build_training(arch, "full", device="cpu")
    cpu_first = float(make_train_step(cpu_loss, opt)(cpu_params, opt.init(cpu_params),
                                                      next(cpu_data))[2]["loss"])
    check(abs(hist[0] - cpu_first) <= 1e-4 * abs(cpu_first),
          f"{arch}: first loss {hist[0]!r} on the card, {cpu_first!r} on the CPU")
    log(f"[gnn] build_training({arch!r}, 'full') on cuda through TrainLoop: {len(hist)} steps "
        f"for {GNN_LOOP_STEPS} (one fault at step 7, restored from step 5), loss "
        f"{hist[0]:.6f} -> {hist[-1]:.6f}, {dt / len(hist) * 1e3:.2f} ms a step (host clock, "
        f"checkpoints included), retries {loop.retries}, checkpoints kept {steps_kept}; the "
        f"first loss on the CPU {cpu_first:.6f} (rel err "
        f"{abs(hist[0] - cpu_first) / abs(cpu_first):.2e})")
    shutil.rmtree(ckpt_dir)


def gnn_host_placement(g):
    """Phase 22's host side, run in a spawned process while the card places
    `g`: `place_graph(device="cpu")`, the labels' reference (host sparse),
    then `placement_report(device="cpu")` and its seconds."""
    import repro_torch.distributed.gnn_placement as gp

    host = gp.place_graph(g, GNN_SHARDS, method="buffcut", device="cpu")
    t0 = time.perf_counter()
    report = gp.placement_report(g, GNN_SHARDS, 602, device="cpu")
    return host, report, time.perf_counter() - t0


def phase_gnn():
    """Phase 22: BuffCut as the GNN placement service on the card, then
    graphsage-reddit trained on the placement at full width, then the three
    other GNN archs through the trainer's entry point.  Returns the
    histogram launches of the placement on the card, the graph and the
    placement's blocks (phase 27's halo loss runs on them)."""
    import concurrent.futures
    import math
    import multiprocessing

    import numpy as np
    import torch

    import repro_torch.distributed.gnn_placement as gp
    from repro_torch.configs import gnn_common, graphsage_reddit
    from repro_torch.configs.buffcut_paper import scaled_config
    from repro_torch.core.metrics import balance, edge_cut, l_max
    from repro_torch.graphs import (
        apply_order,
        cross_block_fraction,
        random_order,
        rgg_graph,
        sample_multihop,
    )
    from repro_torch.kernels import ell_histogram as eh
    from repro_torch.models import gnn
    from repro_torch.train import AdamW, make_train_step
    from repro_torch.tree import tree_map

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off for this check")
    log(f"[gnn] card: {gpu_name_and_limit()}")
    t0 = time.perf_counter()
    g0 = rgg_graph(GNN_NODES, seed=3)
    g = apply_order(g0, random_order(g0, 1))
    t_graph = time.perf_counter() - t0
    del g0
    log(f"[gnn] apply_order(rgg_graph({GNN_NODES}, seed=3), random_order(., 1)): n={g.n} "
        f"m={g.m} average degree {2 * g.m / g.n:.2f} max degree {g.max_degree}, built in "
        f"{t_graph:.3f} s")

    # --- the placement on the card; the same call on the host and the report
    # run meanwhile in a spawned process, which never touches the card
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        host_job = pool.submit(gnn_host_placement, g)
        eh.launches = 0
        t0 = time.perf_counter()
        placement = gp.place_graph(g, GNN_SHARDS, method="buffcut")
        t_place = time.perf_counter() - t0
        launches = eh.launches
        host, report, t_report = host_job.result()
    bc, st, hst = scaled_config(g.n, k=GNN_SHARDS), placement.stats, host.stats
    check(launches > 0, "the BuffCut placement launched no ell_histogram kernel")
    check(np.array_equal(placement.block, host.block),
          "BuffCut labels on cuda differ from the host sparse engine's")
    cut = edge_cut(g, placement.block)
    bal = balance(g, placement.block, GNN_SHARDS)
    check(placement.cut_edges == cut == st.cut_weight,
          f"placement cut {placement.cut_edges}, edge_cut {cut}, streamed {st.cut_weight}")
    cap = l_max(float(g.n), GNN_SHARDS, 0.03)
    check(placement.loads.max() <= cap, f"placement loads {placement.loads.max()} over L_max {cap}")
    perm = gp.reorder_for_shards(g, placement)
    check(np.array_equal(np.sort(perm), np.arange(g.n))
          and bool((np.diff(placement.block[perm]) >= 0).all()),
          "reorder_for_shards is not a shard-major permutation")
    log(f"[gnn] place_graph(g, {GNN_SHARDS}, method='buffcut') on cuda (scaled_config: Q="
        f"{bc.buffer_size} delta={bc.batch_size} d_max={bc.d_max}, engine {bc.ml.engine}): "
        f"{t_place:.3f} s (runtime_s {st.runtime_s:.3f}, ml_time_s {st.ml_time_s:.3f}, "
        f"batches {st.n_batches}), ell_histogram launches {launches}; cut {cut:.0f} (cut "
        f"ratio {cut / g.m:.6f}) balance {bal:.6f}; labels bit-equal to device='cpu' (host "
        f"sparse: runtime_s {hst.runtime_s:.3f}, ml_time_s {hst.ml_time_s:.3f}); shard sizes "
        f"{np.bincount(placement.block, minlength=GNN_SHARDS).tolist()}")
    for method, r in report.items():
        log(f"[gnn] placement_report {method:8s} cut_edges {r['cut_edges']:.0f} halo "
            f"{r['halo_MB_per_layer']:.3f} MB/layer (d_feat 602) imbalance "
            f"{r['load_imbalance']:.6f}")
    check(report["buffcut"]["cut_edges"] == cut, "the report's BuffCut cut differs")
    check(report["buffcut"]["halo_MB_per_layer"] < report["random"]["halo_MB_per_layer"],
          "BuffCut's halo is not below random's")
    log(f"[gnn] placement_report(device='cpu'): {t_report:.3f} s (in the host process, "
        f"after its place_graph; both beside the card's placement)")

    # --- graphsage-reddit at full width on the placement
    cfg = graphsage_reddit.full_config()
    check((cfg.d_in, cfg.d_hidden, cfg.n_classes, cfg.sample_sizes) == (602, 128, 41, (25, 10)),
          f"graphsage-reddit full_config is {cfg}")
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    feats_host = rng.standard_normal((g.n, cfg.d_in), dtype=np.float32)
    torch.cuda.reset_peak_memory_stats()
    feats = torch.from_numpy(feats_host).cuda()
    labels_host = (placement.block % cfg.n_classes).astype(np.int32)
    labels = torch.from_numpy(labels_host).cuda()
    t_feats = time.perf_counter() - t0
    init = gnn.sage_init(torch.Generator().manual_seed(0), cfg)
    params = tree_map(lambda t: t.cuda(), init)
    opt = AdamW(lr=1e-2, warmup_steps=5)
    step = make_train_step(lambda p, b: gnn.sage_loss(p, b, cfg), opt)
    opt_state = opt.init(params)
    b = gnn_common.BATCH_NODES
    losses, sample_ms, iter_ms = [], [], []
    for it in range(GNN_STEPS):
        t0 = time.perf_counter()
        seeds = rng.integers(0, g.n, b)
        layers = sample_multihop(g, seeds, cfg.sample_sizes, seed=it, block_of=placement.block)
        t1 = time.perf_counter()
        ids = [torch.from_numpy(la).cuda() for la in layers]
        batch = {"feats": [feats[i] for i in ids], "labels": labels[ids[0]]}
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        iter_ms.append((time.perf_counter() - t0) * 1e3)
        sample_ms.append((t1 - t0) * 1e3)
        if it == 0:
            first = (layers, seeds, float(metrics["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    check([la.shape[0] for la in first[0]] == [b, b * 25, b * 250],
          f"sampled layers {[la.shape[0] for la in first[0]]}")
    check(all(math.isfinite(x) for x in losses), f"a GraphSAGE loss is not finite: {losses}")
    check(losses[-1] < losses[0], f"the GraphSAGE loss did not fall: {losses}")
    cross = cross_block_fraction(g, layers, placement.block)
    # the first step again on the CPU, from the same weights and samples
    cpu_batch = {"feats": [torch.from_numpy(feats_host[la]) for la in first[0]],
                 "labels": torch.from_numpy(labels_host[first[1]])}
    t0 = time.perf_counter()
    _, _, cpu_m = step(init, opt.init(init), cpu_batch)
    t_cpu = time.perf_counter() - t0
    cpu_loss, cpu_gnorm = float(cpu_m["loss"]), float(cpu_m["grad_norm"])
    check(abs(losses[0] - cpu_loss) <= 1e-4 * abs(cpu_loss)
          and abs(first[2] - cpu_gnorm) <= 1e-4 * abs(cpu_gnorm),
          f"first step: loss {losses[0]!r} / grad norm {first[2]!r} on the card, "
          f"{cpu_loss!r} / {cpu_gnorm!r} on the CPU")
    # one step's device time (CUDA events behind a spin) and wall time
    dev = device_ms(lambda: step(params, opt_state, batch), samples=3, reps=3)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, opt_state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = sorted(walls)[2]
    log(f"[gnn] graphsage-reddit full_config (d_in 602, d_hidden 128, 41 classes, fanout "
        f"25-10), {GNN_STEPS} steps of {b} seeds ({b} + {b * 25} + {b * 250} node slots), "
        f"AdamW(lr=1e-2, warmup_steps=5), partition-aware sampling: loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}; losses {[round(x, 4) for x in losses]}; cross-shard gather "
        f"fraction {cross:.4f}; features {feats_host.nbytes / 1e6:.1f} MB on the card "
        f"({t_feats:.3f} s to draw and copy)")
    log(f"[gnn] a step: sampler {np.median(sample_ms):.1f} ms (host numpy, median of "
        f"{GNN_STEPS}), whole iteration {np.median(iter_ms):.1f} ms (sample, copy ids, "
        f"gather, step, loss to host); the train step alone: device {dev:.3f} ms (CUDA "
        f"events behind a spin), wall {wall:.3f} ms (synchronized), idle share "
        f"{1 - dev / wall:.3f}; peak device memory {peak / 2**30:.3f} GiB")
    log(f"[gnn] first step on the CPU (same weights and samples): loss {cpu_loss:.6f} "
        f"grad norm {cpu_gnorm:.6f}; on the card {losses[0]:.6f} / {first[2]:.6f} (rel err "
        f"{abs(losses[0] - cpu_loss) / abs(cpu_loss):.2e} / "
        f"{abs(first[2] - cpu_gnorm) / abs(cpu_gnorm):.2e}); CPU step {t_cpu:.3f} s")
    del feats, labels, params, opt_state, batch, ids
    torch.cuda.empty_cache()

    # --- the other GNN archs through the trainer's entry point
    for arch in ("egnn", "meshgraphnet", "schnet"):
        gnn_loop_run(arch)
    return launches, g, placement.block


# ------------------------------------------------ phases 23-26: the LM family

# phase 23: moonshot at full width and depth, batch 4, a 1024-token prompt,
# 32 greedy steps; then the other three archs at batch 4, a 256-token prompt
# and 8 steps, llama4-scout and command-r-plus cut to 8 layers (they hold
# 107.8 B and 107.0 B parameters: 215.5 and 213.9 GB in bf16)
MOE_BATCH, MOE_PROMPT, MOE_TOKENS = 4, 1024, 32
OTHER_LMS = (("stablelm-3b", None), ("llama4-scout-17b-a16e", 8), ("command-r-plus-104b", 8))
OTHER_PROMPT, OTHER_TOKENS = 256, 8
# phase 24: moonshot at full width, 2 of 48 layers, float32; batch 2, a
# 64-token prompt, 4 decode steps fed the same tokens on both devices
PARITY_LAYERS, PARITY_BATCH, PARITY_PROMPT, PARITY_STEPS = 2, 2, 64, 4
# phase 25: h2o-danube-1.8b at full width and depth, then moonshot at 2 of
# 48 layers, batch 8 x seq 128 (the trainer's defaults)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 8, 128, 20, 2, 10
# phase 26: dlrm-mlperf at full width with 2^18 rows a table, 20 steps
DLRM_TRAIN_ROWS, DLRM_TRAIN_BATCH, DLRM_TRAIN_STEPS = 1 << 18, 4096, 20


def kernel_modules() -> dict:
    from repro_torch.kernels import ell_histogram as eh
    from repro_torch.kernels import fennel_gain as fg
    from repro_torch.kernels import swa_attention as sw

    return {"ell_histogram": eh, "swa_attention": sw,
            "embedding_bag": importlib.import_module("repro_torch.kernels.embedding_bag"),
            "fennel_gain": fg}


def zero_launches() -> None:
    """Every kernel wrapper's launch count set to 0 (the sweep's too)."""
    for mod in kernel_modules().values():
        mod.launches = 0
    kernel_modules()["fennel_gain"].sweep_launches = 0


def read_launches() -> dict:
    counts = {name: mod.launches for name, mod in kernel_modules().items()}
    counts["fennel_sweep"] = kernel_modules()["fennel_gain"].sweep_launches
    return counts


def fresh_card(tag: str) -> None:
    """Before a run that fills the card: collect garbage, empty the
    allocator's cache and log what is still allocated."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{tag}] device memory allocated before the run: "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")


def lm_params_on_card(cfg, seed: int):
    """`init_params` on the card, its size checked against the config."""
    import torch

    from repro_torch.models import transformer as tfm

    t0 = time.perf_counter()
    params = tfm.init_params(torch.Generator(device="cuda").manual_seed(seed), cfg)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in params.values())
    check(n == cfg.param_count(), f"{cfg.name}: {n} parameters, config says {cfg.param_count()}")
    return params, n, time.perf_counter() - t0


def serve_one(cfg, batch: int, prompt: int, tokens: int, tag: str, seed: int = 0):
    """`serve_lm` of `cfg` on the card from weights drawn there: finite
    logits, tokens in range; returns (result, params, peak bytes)."""
    import torch

    from repro_torch.launch.serve import serve_lm

    fresh_card(tag)
    torch.cuda.reset_peak_memory_stats()
    params, n, t_draw = lm_params_on_card(cfg, seed)
    size = n * params["embed"].element_size()
    log(f"[{tag}] {cfg.name}: {n} parameters ({size / 1e9:.2f} GB in {cfg.dtype}, "
        f"{cfg.n_layers} layers, {cfg.n_experts} experts) drawn on the card in {t_draw:.2f} s")
    res = serve_lm(cfg, batch, prompt, tokens, device="cuda", params=params)
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(res.logits).all()), f"{cfg.name}: serve logits are not finite")
    check(res.tokens.shape == (batch, tokens + 1)
          and bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()),
          f"{cfg.name}: bad served tokens")
    log(f"[{tag}] {cfg.name} batch {batch}, prompt {prompt}, {tokens} new tokens: prefill "
        f"{res.prefill_s:.4f} s ({batch * prompt / res.prefill_s:.0f} prompt tok/s), decode "
        f"{res.decode_s:.4f} s ({res.tokens_per_s:.1f} tok/s, {res.decode_s / tokens * 1e3:.3f} "
        f"ms/step), peak memory {peak / 2**30:.3f} GiB")
    return res, params, peak


def phase_moe_serve() -> dict:
    """Phase 23: moonshot-v1-16b-a3b served at full width and depth, the
    experts that received a token at prefill, the step against its byte
    bound; then stablelm-3b, llama4-scout and command-r-plus at full width
    (the last two at 8 layers).  Returns the kernels' launch counts."""
    import dataclasses as dc
    from unittest import mock

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tfm

    cfg = get_arch("moonshot-v1-16b-a3b").full_config()
    check(cfg.param_count() == 28_888_467_456, f"moonshot holds {cfg.param_count()}")
    # the prefill's routing, read after the run: each layer's slots and keep
    routed = []
    real_dispatch = tfm._moe_dispatch

    def recording(x, router, e, k, cap):
        out = real_dispatch(x, router, e, k, cap)
        if x.shape[0] == MOE_BATCH * MOE_PROMPT:
            routed.append((out[0], out[3], cap))
        return out

    zero_launches()
    with mock.patch.object(tfm, "_moe_dispatch", recording):
        res, params, _ = serve_one(cfg, MOE_BATCH, MOE_PROMPT, MOE_TOKENS, "moe_serve")
    counts = read_launches()
    check(len(routed) == cfg.n_layers, f"{len(routed)} MoE layers routed at prefill")
    used, kept = [], []
    for slot, keep, cap in routed:
        experts = torch.unique(slot[keep.reshape(-1)] // cap)
        used.append(int(experts.numel()))
        kept.append(float(keep.float().mean()))
    # a decode step at T = B tokens: cap = _moe_cap(B, k, E) rows for every
    # expert, so every expert's weights are read; the embedding table is
    # read for B rows only; the cache up to the mean fill
    cap = tfm._moe_cap(MOE_BATCH, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    weight_bytes = 2 * (cfg.param_count() - cfg.vocab * cfg.d_model)
    fill = MOE_PROMPT + (MOE_TOKENS + 1) / 2
    cache_bytes = 2 * 2 * cfg.n_layers * MOE_BATCH * fill * cfg.n_kv_heads * cfg.d_head
    step_ms = res.decode_s / MOE_TOKENS * 1e3
    bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[moe_serve] prefill routing ({MOE_BATCH * MOE_PROMPT} tokens, top-{cfg.top_k} of "
        f"{cfg.n_experts}, cap {routed[0][2]}): experts that received a token per layer min "
        f"{min(used)} median {int(np.median(used))} max {max(used)} of {cfg.n_experts}; kept "
        f"share of (token, choice) min {min(kept):.4f} mean {np.mean(kept):.4f}")
    log(f"[moe_serve] decode step: {step_ms:.3f} ms against a byte bound of {bound_ms:.3f} ms "
        f"({weight_bytes / 1e9:.2f} GB of weights: at T = {MOE_BATCH} the capacity is {cap} "
        f"rows for each of the {cfg.n_experts} experts, so every expert is read; "
        f"{(weight_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3:.3f} ms with the KV cache's "
        f"{cache_bytes / 1e9:.3f} GB), {bound_ms / step_ms:.3f} of the bound; launches {counts}")
    del params, res, routed
    torch.cuda.empty_cache()

    for arch, layers in OTHER_LMS:
        full = get_arch(arch).full_config()
        cfg = full if layers is None else dc.replace(full, n_layers=layers)
        if layers is not None:
            log(f"[moe_serve] reduced: {arch} n_layers {full.n_layers} -> {layers} "
                f"({full.param_count() / 1e9:.1f} B parameters, {2 * full.param_count() / 1e9:.1f} "
                f"GB in bf16, do not fit one 80 GB card; {cfg.param_count() / 1e9:.1f} B, "
                f"{2 * cfg.param_count() / 1e9:.1f} GB at {layers} layers)")
        zero_launches()
        res, params, _ = serve_one(cfg, MOE_BATCH, OTHER_PROMPT, OTHER_TOKENS, "moe_serve")
        more = read_launches()
        counts = {k: counts[k] + more[k] for k in counts}
        del params, res
        torch.cuda.empty_cache()
    return counts


def phase_moe_parity() -> dict:
    """Phase 24: moonshot at full width, 2 of 48 layers, float32 (TF32
    off): prefill and 4 decode steps on the card and on the CPU from the
    same weights; one MoE layer with duplicated router columns routed
    alike on both; the layer twice on the card, bit for bit."""
    import dataclasses as dc

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tfm

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off for this check")
    full = get_arch("moonshot-v1-16b-a3b").full_config()
    cfg = dc.replace(full, n_layers=PARITY_LAYERS, dtype="float32")
    log(f"[moe_parity] reduced: {full.name} n_layers {full.n_layers} -> {PARITY_LAYERS}, "
        f"float32 ({cfg.param_count() * 4 / 1e9:.2f} GB, held on the card and on the host)")
    fresh_card("moe_parity")
    params, _, _ = lm_params_on_card(cfg, seed=1)
    t0 = time.perf_counter()
    host = {k: v.cpu() for k, v in params.items()}
    t_copy = time.perf_counter() - t0
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab, (PARITY_BATCH, PARITY_PROMPT + PARITY_STEPS)).astype(np.int32)
    max_len = PARITY_PROMPT + PARITY_STEPS + 1
    zero_launches()
    out = {}
    with torch.inference_mode():
        for dev, p in (("cuda", params), ("cpu", host)):
            t = torch.from_numpy(toks).to(dev)
            t0 = time.perf_counter()
            logits, cache = tfm.forward_prefill(p, t[:, :PARITY_PROMPT], cfg, max_len)
            steps = [logits]
            for i in range(PARITY_STEPS):
                logits, cache = tfm.forward_decode(
                    p, t[:, PARITY_PROMPT + i:PARITY_PROMPT + i + 1], cache, cfg)
                steps.append(logits)
            out[dev] = torch.cat(steps, dim=1).cpu()
            log(f"[moe_parity] prefill + {PARITY_STEPS} decode steps on {dev}: "
                f"{time.perf_counter() - t0:.3f} s")
    check(bool(torch.isfinite(out["cuda"]).all()), "card logits are not finite")
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-3, atol=1e-3)
    err = float((out["cuda"] - out["cpu"]).abs().max())

    # one layer, its router's odd columns copies of the even ones
    e, k = cfg.n_experts, cfg.top_k
    layer = tfm._layers(params)[0]
    layer["router"] = layer["router"].clone()
    layer["router"][:, 1::2] = layer["router"][:, 0::2]
    host_layer = {key: v.cpu() for key, v in layer.items()}
    x = torch.randn((MOE_BATCH * MOE_PROMPT, cfg.d_model),
                    generator=torch.Generator().manual_seed(3))
    cap = tfm._moe_cap(x.shape[0], k, e, cfg.capacity_factor)
    with torch.inference_mode():
        card_route = tfm._moe_dispatch(x.cuda(), layer["router"], e, k, cap)
        host_route = tfm._moe_dispatch(x, host_layer["router"], e, k, cap)
        for name, i in (("slot", 0), ("token", 1), ("keep", 3)):
            check(torch.equal(card_route[i].cpu(), host_route[i]),
                  f"tied router: {name} on the card differs from the CPU's")
        chosen = card_route[0][card_route[3].reshape(-1)] // cap
        odd = chosen[chosen % 2 == 1]
        check(bool(torch.isin(odd - 1, chosen).all()), "a tie did not go to the lower expert")
        x3 = x.cuda().reshape(MOE_BATCH, MOE_PROMPT, cfg.d_model)
        first = tfm.moe_ffn(x3, layer, cfg)
        again = tfm.moe_ffn(x3, layer, cfg)
        torch.cuda.synchronize()
    counts = read_launches()
    check(torch.equal(first, again), "the MoE layer's rerun on the card is not bit-equal")
    log(f"[moe_parity] card == CPU: prefill + {PARITY_STEPS} decode logits (batch "
        f"{PARITY_BATCH}, prompt {PARITY_PROMPT}) at rtol/atol 1e-3, max_abs_err={err:g} "
        f"(|logits| max {float(out['cpu'].abs().max()):.3f}; weights to the host in "
        f"{t_copy:.2f} s); tied router ({e // 2} pairs, {x.shape[0]} tokens, cap {cap}): slots, "
        f"tokens and keep equal, {int(chosen.numel())} kept choices, every odd expert with its "
        f"even twin; the layer twice on the card: bit-equal; launches {counts}")
    del params, host, layer, host_layer, first, again
    torch.cuda.empty_cache()
    return counts


def first_loss_parity(full, seed: int) -> None:
    """`full` at 2 layers in float32: the first train step's loss on the
    card (through autograd, each layer recomputed) against `loss_fn` on the
    CPU from the same weights, within rtol 1e-4."""
    import dataclasses as dc

    import torch

    from repro_torch.models import transformer as tfm
    from repro_torch.train.data import token_batches
    from repro_torch.train.loop import value_and_grad

    cfg = dc.replace(full, n_layers=2, dtype="float32")
    params, _, _ = lm_params_on_card(cfg, seed)
    batch = next(token_batches(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, device="cpu"))
    loss, grads = value_and_grad(lambda p, b: tfm.loss_fn(p, b, cfg), params,
                                 {k: v.cuda() for k, v in batch.items()})
    card = float(loss)
    gnorm = float(torch.sqrt(sum(g.float().square().sum() for g in grads.values())))
    del grads
    host = {k: v.cpu() for k, v in params.items()}
    del params
    torch.cuda.empty_cache()
    with torch.no_grad():
        cpu = float(tfm.loss_fn(host, batch, cfg))
    check(abs(card - cpu) <= 1e-4 * abs(cpu),
          f"{full.name}: first loss {card!r} on the card, {cpu!r} on the CPU")
    log(f"[train_lm] {full.name} at 2 layers, float32: first loss on the card {card:.6f} "
        f"(gradient norm {gnorm:.6f}), on the CPU {cpu:.6f}, rel err "
        f"{abs(card - cpu) / abs(cpu):.2e}")


def traced_device_ms(fn, attempts: int = 3) -> float | None:
    """Device milliseconds of one call of `fn`: the sum of its device rows
    (kernels, memsets, copies) in a torch.profiler trace of device activity.
    A step of thousands of launches fills the card's launch queue, so the
    spin that `device_ms` hides the host behind cannot cover it.  Traces
    late in a long run have come back missing records, so two traces must
    hold the same number of device records (a DLRM step alternates between
    two counts); None (not measured) when no two in `attempts` + 1 do."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for _ in range(attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        count = sum(e.count for e in rows)
        total = sum(e.self_device_time_total for e in rows) / 1e3
        if count > 0 and any(c == count for c, _ in seen):
            return total
        seen.append((count, total))
    log(f"[env] no two profiler traces of a step held the same device records: {seen}")
    return None


def train_run(tag: str, loss, opt, params, data, steps: int, per_step: tuple[int, str]):
    """`steps` steps of `make_train_step(loss, opt)` through `TrainLoop`
    (no checkpoint within the run); then one step's device time (a
    profiler trace) against its wall time, and the rate of `per_step`'s
    items.  Returns the losses."""
    import math
    import shutil

    import numpy as np
    import torch

    from repro_torch.train import CheckpointManager, LoopConfig, TrainLoop, make_train_step

    ckpt_dir = OOC_DIR / f"train_{tag}"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    step = make_train_step(loss, opt)
    fresh_card(tag)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loop = TrainLoop(step, CheckpointManager(str(ckpt_dir)),
                     LoopConfig(total_steps=steps, checkpoint_every=steps + 1))
    t0 = time.perf_counter()
    # the first moments are not named here, so the loop frees them after
    # its first step (the peak is then that of a step)
    (params, opt_state), hist = loop.run(params, opt.init(params), data)
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(len(hist) == steps and loop.retries == 0, f"{tag}: {len(hist)} losses, "
          f"{loop.retries} retries")
    check(all(math.isfinite(x) for x in hist), f"{tag}: a loss is not finite: {hist}")
    batch = next(data)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step(params, opt_state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    wall = float(np.median(walls))
    dev = traced_device_ms(lambda: step(params, opt_state, batch))
    busy = ("device not measured" if dev is None else
            f"device {dev:.3f} ms (profiler rows), idle share {1 - dev / wall:.3f}")
    log(f"[{tag}] {steps} steps through TrainLoop in {dt:.3f} s (the first included), loss "
        f"{hist[0]:.6f} -> {hist[-1]:.6f}; losses {[round(x, 4) for x in hist]}; a step: wall "
        f"{wall:.3f} ms (synchronized, median of 3), {busy}, {per_step[0] / wall * 1e3:.0f} "
        f"{per_step[1]}/s; peak device memory {peak / 2**30:.3f} GiB")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return hist


def phase_train_lm() -> dict:
    """Phase 25: h2o-danube-1.8b trained at full width and depth through
    `build_training(..., "full")`, `make_train_step` and `TrainLoop`; then
    moonshot at full width, 2 of 48 layers (the MoE backward); each first
    loss against the CPU's at 2 layers in float32."""
    import dataclasses as dc

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.train import build_training
    from repro_torch.models import transformer as tfm
    from repro_torch.train import AdamW
    from repro_torch.train.data import token_batches

    fresh_card("train_lm")
    zero_launches()
    t0 = time.perf_counter()
    cfg, params, loss, data = build_training("h2o-danube-1.8b", "full", TRAIN_BATCH,
                                             TRAIN_SEQ, device="cuda")
    torch.cuda.synchronize()
    log(f"[train_lm] build_training('h2o-danube-1.8b', 'full', {TRAIN_BATCH}, {TRAIN_SEQ}): "
        f"{cfg.param_count()} parameters drawn on the host and moved to the card in "
        f"{time.perf_counter() - t0:.2f} s")
    # the optimizer `python -m repro_torch.launch.train --steps 20` builds
    opt = AdamW(lr=3e-4, warmup_steps=TRAIN_STEPS // 10 + 1)
    hist = train_run("train_lm", loss, opt, params, data, TRAIN_STEPS,
                     (TRAIN_BATCH * TRAIN_SEQ, "tokens"))
    check(hist[-1] < hist[0], f"the h2o-danube loss did not fall: {hist}")
    del params, data
    torch.cuda.empty_cache()
    first_loss_parity(cfg, seed=4)

    full = get_arch("moonshot-v1-16b-a3b").full_config()
    cfg = dc.replace(full, n_layers=MOE_TRAIN_LAYERS)
    log(f"[train_lm] reduced: {full.name} n_layers {full.n_layers} -> {MOE_TRAIN_LAYERS} "
        f"({cfg.param_count() / 1e9:.2f} B parameters; the functional AdamW holds two sets "
        f"of float32 moments, 16 bytes a parameter, so {full.n_layers} layers would need "
        f"{full.param_count() * 16 / 1e9:.0f} GB for them alone)")
    params, _, _ = lm_params_on_card(cfg, seed=5)
    opt = AdamW(lr=3e-4, warmup_steps=MOE_TRAIN_STEPS // 10 + 1)
    train_run("train_moe", lambda p, b: tfm.loss_fn(p, b, cfg), opt, params,
              token_batches(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, device="cuda"),
              MOE_TRAIN_STEPS, (TRAIN_BATCH * TRAIN_SEQ, "tokens"))
    del params
    torch.cuda.empty_cache()
    first_loss_parity(full, seed=6)
    counts = read_launches()
    log(f"[train_lm] launches {counts}")
    return counts


def phase_train_dlrm() -> dict:
    """Phase 26: dlrm-mlperf at full width with 2^18 rows a table, trained
    through `TrainLoop`; its loss pools through the plain bag, so the
    phase launches no embedding_bag kernel.  The first loss against the
    CPU's from the same weights."""
    import dataclasses as dc

    import torch

    from repro_torch.configs import dlrm_mlperf
    from repro_torch.models.dlrm import dlrm_init, dlrm_loss
    from repro_torch.train import AdamW
    from repro_torch.train.data import dlrm_batches
    from repro_torch.tree import tree_map

    full = dlrm_mlperf.full_config()
    cfg = dc.replace(full, vocab_size=DLRM_TRAIN_ROWS)
    tables = lambda c: c.n_sparse * c.vocab_size * c.embed_dim * 4 / 1e9  # noqa: E731
    log(f"[train_dlrm] reduced: vocab_size {full.vocab_size} -> {cfg.vocab_size} rows a table "
        f"(tables {tables(full):.2f} -> {tables(cfg):.2f} GB; a step of the functional AdamW "
        f"holds ~12 times the tables: the state, its gradient, the new state and the update's "
        f"temporaries, past 80 GB at full size)")
    fresh_card("train_dlrm")
    zero_launches()
    params = dlrm_init(torch.Generator(device="cuda").manual_seed(0), cfg)
    loss = lambda p, b: dlrm_loss(p, b, cfg)  # noqa: E731
    first = next(dlrm_batches(cfg, DLRM_TRAIN_BATCH, device="cpu"))
    with torch.no_grad():
        card = float(loss(params, {k: v.cuda() for k, v in first.items()}))
        cpu = float(loss(tree_map(lambda t: t.cpu(), params), first))
    check(abs(card - cpu) <= 1e-4 * abs(cpu), f"DLRM first loss {card!r} on the card, "
          f"{cpu!r} on the CPU")
    hist = train_run("train_dlrm", loss, AdamW(lr=3e-4, warmup_steps=DLRM_TRAIN_STEPS // 10 + 1),
                     params, dlrm_batches(cfg, DLRM_TRAIN_BATCH, device="cuda"),
                     DLRM_TRAIN_STEPS, (DLRM_TRAIN_BATCH, "samples"))
    counts = read_launches()
    check(counts["embedding_bag"] == 0, f"DLRM training launched {counts['embedding_bag']} "
          "embedding_bag kernels")
    log(f"[train_dlrm] batch {DLRM_TRAIN_BATCH}: first loss on the card {card:.6f}, on the CPU "
        f"{cpu:.6f} (rel err {abs(card - cpu) / abs(cpu):.2e}); last {hist[-1]:.6f}; launches "
        f"{counts}")
    del params
    torch.cuda.empty_cache()
    return counts


# ------------------------------------------------------------- phase 27: the mesh

# h2o-danube-1.8b's prefill_32k and decode_32k cells at batch 4 (the cells'
# own batches are 32 and 128), a 1024-token prompt and 8 decode steps
MESH_BATCH, MESH_PROMPT, MESH_STEPS = 4, 1024, 8
# moonshot at full width, 2 of 48 layers, batch 4, a 256-token prompt, the
# prefill_32k cell's 32768 cache positions
MESH_MOE_LAYERS, MESH_MOE_PROMPT = 2, 256
MESH_GNN_STEPS = 5
# the dry-run's cells on the 16x16 fake mesh, each in its own process
MESH_DRY = (("stablelm-3b", "train_4k"), ("dlrm-mlperf", "serve_p99"))


def wall_ms(fn, reps: int = 3) -> float:
    """Median synchronized wall milliseconds of `fn`."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def max_diff(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def start_dry_runs() -> dict:
    """The dry-run of MESH_DRY, one process a cell (the fake process group
    is process-wide), started now and read by `finish_dry_runs`."""
    import os

    OOC_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    for arch, shape in MESH_DRY:
        out = OOC_DIR / f"dryrun_{arch}_{shape}.jsonl"
        out.unlink(missing_ok=True)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--json", str(out)]
        procs[(arch, shape)] = (subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT), out)
    return procs


def finish_dry_runs(procs: dict) -> None:
    for (arch, shape), (p, out) in procs.items():
        try:
            text = p.communicate(timeout=600)[0].decode()
        finally:
            if p.poll() is None:
                p.kill()
        check(p.returncode == 0, f"dry-run {arch} x {shape} failed:\n{text[-3000:]}")
        r = json.loads(out.read_text().splitlines()[0])
        out.unlink()
        check(r["status"] == "ok" and r["mesh"] == "16x16", f"dry-run {arch} x {shape}: {r}")
        b, c, f = r["bytes_per_device"], r["collectives"], r["roofline"]
        log(f"[mesh] dry-run {arch} x {shape} on the fake 16x16 mesh ({r['device_type']}, "
            f"FakeTensorMode, per rank): step {r['step_s']} s; args {b['args']} B, peak live "
            f"{b['peak']} B; collectives {c['total']} B in {c['count']} (all_gather "
            f"{c['all_gather']}, all_reduce {c['all_reduce']}, reduce_scatter "
            f"{c['reduce_scatter']}, all_to_all {c['all_to_all']}); flops {f['flops']:.6g}, "
            f"bytes accessed {f['hbm_bytes']:.6g}; terms on one H100 SXM's published peaks: "
            f"compute {f['t_compute_s']:.6g} s, memory {f['t_memory_s']:.6g} s, collective "
            f"{f['t_collective_s']:.6g} s, bottleneck {f['bottleneck']}; model flops "
            f"{f['model_flops']:.6g} ({f['useful_flops_frac']:.4f} of 256 ranks' flops); "
            f"notes: {r['notes'] or '-'}")


def phase_mesh(gnn_graph, gnn_block) -> dict:
    """Phase 27: the device mesh at world 1 on NCCL through the cells' own
    step functions, each against its plain function, and the dry-run on the
    fake 16x16 mesh.  Returns the kernels' launches on the mesh path."""
    import dataclasses as dc

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_arch, graphsage_reddit
    from repro_torch.configs.dlrm_mlperf import draw_batch
    from repro_torch.launch.mesh import init_world_of_one, make_host_mesh
    from repro_torch.launch.steps import (_GNN_LOSS, build_cell, full_value, place_args,
                                          step_cell)
    from repro_torch.models import dlrm as dlrm_mod
    from repro_torch.models import gnn
    from repro_torch.models import transformer as tfm
    from repro_torch.train import AdamW, make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off for this check")
    dry = start_dry_runs()
    fresh_card("mesh")
    init_world_of_one("cuda")
    launches = {}
    try:
        mesh = make_host_mesh(1, 1, device="cuda")
        check(dist.get_backend() == "nccl", f"the world of one runs {dist.get_backend()}")
        log(f"[mesh] world of one: backend {dist.get_backend()}, ranks "
            f"{dist.get_world_size()}, mesh {mesh.mesh_dim_names} "
            f"{tuple(mesh.size(i) for i in range(mesh.ndim))} on {mesh.device_type}")

        # --- h2o-danube-1.8b: the prefill_32k and decode_32k cells
        cfg = get_arch("h2o-danube-1.8b").full_config()
        pre = build_cell("h2o-danube-1.8b", "prefill_32k", mesh)
        dec = build_cell("h2o-danube-1.8b", "decode_32k", mesh)
        max_len = pre.arg_structs[1]["tokens"].shape[1]
        params, n, _ = lm_params_on_card(cfg, seed=0)
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, (MESH_BATCH, MESH_PROMPT)).astype(np.int32)).cuda()
        zero_launches()
        t0 = time.perf_counter()
        logits, cache = step_cell(pre, mesh, (params, {"tokens": toks}))
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        tok = full_value(logits).argmax(-1).to(torch.int32)
        got, step_ms = [full_value(logits)], []
        dparams = place_args(dec, mesh, (params, {"tokens": tok, "cache": cache}))[0]
        for _ in range(MESH_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = step_cell(dec, mesh, (dparams, {"tokens": tok, "cache": cache}))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            got.append(full_value(lg))
            tok = got[-1].argmax(-1).to(torch.int32)
        lm_counts = read_launches()
        check(lm_counts["swa_attention"] == MESH_STEPS * cfg.n_layers,
              f"decode cell: {lm_counts['swa_attention']} swa_attention launches, want "
              f"{MESH_STEPS} x {cfg.n_layers}")
        mesh_cache = {k: full_value(v) for k, v in cache.items()}
        del cache
        # the plain functions on the same weights and tokens
        t0 = time.perf_counter()
        want_l, want_c = tfm.forward_prefill(params, toks, cfg, max_len)
        torch.cuda.synchronize()
        t_pre_plain = time.perf_counter() - t0
        want, plain_ms = [want_l], []
        tok = want_l.argmax(-1).to(torch.int32)
        for _ in range(MESH_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wl, want_c = tfm.forward_decode(params, tok, want_c, cfg)
            torch.cuda.synchronize()
            plain_ms.append((time.perf_counter() - t0) * 1e3)
            want.append(wl)
            tok = wl.argmax(-1).to(torch.int32)
        for i, (a, b) in enumerate(zip(got, want)):
            check(torch.equal(a, b), f"h2o-danube step {i}: mesh logits differ from the plain "
                  f"function's by {max_diff(a, b)}")
        for k in ("k", "v", "pos"):
            check(torch.equal(mesh_cache[k], want_c[k]), f"h2o-danube: the mesh cache's {k} "
                  "differs from the plain cache's")
        log(f"[mesh] h2o-danube-1.8b full width ({n} parameters, bf16) through the "
            f"prefill_32k and decode_32k cells (reduced: batch {MESH_BATCH} of the cells' 32 "
            f"and 128, a {MESH_PROMPT}-token prompt, {MESH_STEPS} decode steps; the cache at "
            f"the cell's {max_len} positions): logits of the prefill and of every step "
            f"bit-equal to plain forward_prefill / forward_decode, the caches equal; "
            f"swa_attention launches from the decode cell {lm_counts['swa_attention']} "
            f"({MESH_STEPS} x {cfg.n_layers}); prefill {t_pre:.4f} s on the mesh, "
            f"{t_pre_plain:.4f} s plain (the first run of each includes warm-up); a decode "
            f"step {np.median(step_ms):.3f} ms on the mesh, {np.median(plain_ms):.3f} ms plain "
            f"(medians of {MESH_STEPS}, synchronized wall)")
        launches = lm_counts
        del params, dparams, want_c, mesh_cache, got, want
        fresh_card("mesh")

        # --- moonshot at full width, 2 of 48 layers: the expert-parallel MoE
        full = get_arch("moonshot-v1-16b-a3b").full_config()
        mcfg = dc.replace(full, n_layers=MESH_MOE_LAYERS)
        mpre = build_cell("moonshot-v1-16b-a3b", "prefill_32k", mesh, cfg_override=mcfg)
        mparams, mn, _ = lm_params_on_card(mcfg, seed=1)
        mtoks = torch.from_numpy(np.random.default_rng(1).integers(
            0, mcfg.vocab, (MESH_BATCH, MESH_MOE_PROMPT)).astype(np.int32)).cuda()
        zero_launches()
        t0 = time.perf_counter()
        ml, _ = step_cell(mpre, mesh, (mparams, {"tokens": mtoks}))
        torch.cuda.synchronize()
        t_moe = time.perf_counter() - t0
        for name, c in read_launches().items():
            launches[name] += c
        wl, _ = tfm.forward_prefill(mparams, mtoks, mcfg, max_len)
        check(torch.equal(full_value(ml), wl), f"moonshot: the expert-parallel MoE at (1, 1) "
              f"differs from the one-device MoE by {max_diff(full_value(ml), wl)}")
        log(f"[mesh] moonshot-v1-16b-a3b full width, {MESH_MOE_LAYERS} of {full.n_layers} "
            f"layers (reduced), {mn} parameters: prefill of batch {MESH_BATCH} x "
            f"{MESH_MOE_PROMPT} with set_moe_spmd on the (1, 1) mesh (local dispatch, two "
            f"all_to_all_single on NCCL) through the prefill_32k cell bit-equal to the "
            f"one-device MoE's forward_prefill; {t_moe:.4f} s")
        del mparams
        fresh_card("mesh")

        # --- dlrm-mlperf at full width: the serve_p99 and retrieval_cand cells
        dcfg = get_arch("dlrm-mlperf").full_config()
        dparams = dlrm_mod.dlrm_init(torch.Generator(device="cuda").manual_seed(0), dcfg)
        serve = build_cell("dlrm-mlperf", "serve_p99", mesh)
        retr = build_cell("dlrm-mlperf", "retrieval_cand", mesh)
        b = draw_batch(dcfg, DLRM_P99, seed=DLRM_P99)
        batch = {k: v.cuda() for k, v in b.items() if k != "labels"}
        q = draw_batch(dcfg, 1, seed=1)
        rbatch = {"query_dense": q["dense"].cuda(), "query_sparse_idx": q["sparse_idx"].cuda(),
                  "query_sparse_mask": q["sparse_mask"].cuda(),
                  "candidates": torch.randn((DLRM_CANDIDATES, dcfg.embed_dim),
                                            generator=torch.Generator(device="cuda")
                                            .manual_seed(2), device="cuda")}
        zero_launches()
        with torch.no_grad():
            s_params = place_args(serve, mesh, (dparams, batch))[0]   # the tables' layout once
            s_out = full_value(step_cell(serve, mesh, (s_params, batch)))
            r_out = full_value(step_cell(retr, mesh, (s_params, rbatch)))
        torch.cuda.synchronize()
        d_counts = read_launches()
        check(d_counts["embedding_bag"] == 2, f"DLRM cells: {d_counts['embedding_bag']} "
              "embedding_bag launches, want one a cell")
        for name, c in d_counts.items():
            launches[name] += c
        with torch.no_grad():
            s_want = dlrm_mod.dlrm_forward(dparams, batch, dcfg)
            r_want = dlrm_mod.dlrm_retrieval(dparams, rbatch, dcfg)
            check(torch.equal(s_out, s_want), f"serve_p99 cell differs from dlrm_forward by "
                  f"{max_diff(s_out, s_want)}")
            check(torch.equal(r_out, r_want), f"retrieval_cand cell differs from "
                  f"dlrm_retrieval by {max_diff(r_out, r_want)}")
            s_ms = wall_ms(lambda: step_cell(serve, mesh, (s_params, batch)), reps=5)
            s_plain = wall_ms(lambda: dlrm_mod.dlrm_forward(dparams, batch, dcfg), reps=5)
            r_ms = wall_ms(lambda: step_cell(retr, mesh, (s_params, rbatch)), reps=5)
            r_plain = wall_ms(lambda: dlrm_mod.dlrm_retrieval(dparams, rbatch, dcfg), reps=5)
        log(f"[mesh] dlrm-mlperf full width (26 x 2^20 x 128 tables): the serve_p99 cell "
            f"(batch {DLRM_P99}) bit-equal to dlrm_forward, the retrieval_cand cell "
            f"({DLRM_CANDIDATES} candidates) bit-equal to dlrm_retrieval; embedding_bag "
            f"launches from the cells {d_counts['embedding_bag']} (the bag on the tables' "
            f"local shard); a call {s_ms:.3f} ms on the mesh against {s_plain:.3f} ms plain "
            f"(serve_p99), {r_ms:.3f} against {r_plain:.3f} ms (retrieval_cand); medians of 5 "
            f"synchronized walls")
        del dparams, s_params, rbatch
        fresh_card("mesh")

        # --- graphsage-reddit: the minibatch_lg train cell, 5 steps
        gcell = build_cell("graphsage-reddit", "minibatch_lg", mesh)
        gcfg = dc.replace(graphsage_reddit.full_config(), n_classes=41)
        shapes = {k: tuple(v.shape) for k, v in gcell.arg_structs[2].items()}
        rng = np.random.default_rng(0)
        n_nodes, n_edges = shapes["x"][0], shapes["edge_src"][0]
        gbatch = {
            "x": torch.from_numpy(rng.standard_normal(shapes["x"], dtype=np.float32)),
            "labels": torch.from_numpy(rng.integers(0, 41, n_nodes).astype(np.int32)),
            "node_mask": torch.ones(n_nodes),
            "edge_src": torch.from_numpy(rng.integers(0, n_nodes, n_edges).astype(np.int32)),
            "edge_dst": torch.from_numpy(rng.integers(0, n_nodes, n_edges).astype(np.int32)),
            "edge_mask": torch.ones(n_edges),
        }
        gbatch = {k: v.cuda() for k, v in gbatch.items()}
        gparams = tree_map(lambda t: t.cuda(),
                           gnn.sage_init(torch.Generator().manual_seed(0), gcfg))
        opt = AdamW()
        step = make_train_step(lambda p, bb: _GNN_LOSS["graphsage-reddit"](p, bb, gcfg), opt)
        p1, o1, p2, o2 = gparams, opt.init(gparams), gparams, opt.init(gparams)
        cell_ms, plain_gms, worst = [], [], 0.0
        for it in range(MESH_GNN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p2, o2, m2 = step_cell(gcell, mesh, (p2, o2, gbatch))   # DTensors stay placed
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            p1, o1, m1 = step(p1, o1, gbatch)
            torch.cuda.synchronize()
            cell_ms.append((t1 - t0) * 1e3)
            plain_gms.append((time.perf_counter() - t1) * 1e3)
            for key in ("loss", "grad_norm"):
                v1, v2 = float(m1[key]), float(full_value(m2[key]))
                check(abs(v1 - v2) <= 1e-5 * abs(v1), f"GNN step {it}: the cell's {key} "
                      f"{v2!r}, make_train_step's {v1!r}")
                worst = max(worst, abs(v1 - v2) / abs(v1))
        pd = max(max_diff(a, full_value(b)) for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
        log(f"[mesh] graphsage-reddit full_config through the minibatch_lg train cell "
            f"({n_nodes} nodes, {n_edges} edges, d_in 602, 41 classes), {MESH_GNN_STEPS} "
            f"steps against make_train_step's on the same batch: every step's loss and "
            f"gradient norm within rtol 1e-5 (largest relative difference {worst:.3g}; the "
            f"parameters after them differ by at most {pd:.3g}: the segment sums are "
            f"index_add, float atomics on the card, so neither side repeats its own bits); "
            f"a step {np.median(cell_ms):.3f}"
            f" ms through the cell, {np.median(plain_gms):.3f} ms plain (medians of "
            f"{MESH_GNN_STEPS})")
        del gbatch, gparams, p1, o1, p2, o2
        fresh_card("mesh")

        mesh_halo(mesh, gnn_graph, gnn_block)
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
        finish_dry_runs(dry)
    return launches


def mesh_halo(mesh, graph, block) -> None:
    """`sage_fullgraph_halo_loss` and its gradients at graphsage-reddit's
    full width on `graph` placed by `block`, shard-major, against
    `sage_loss` on the assembled graph.  In float32 both sums run in
    float atomics (index_add) and in other orders, so the loss is held at
    rtol 1e-5 and the gradients' difference is printed beside the whole-
    graph path's difference from a rerun of itself; in float64 the same
    weights and features hold every gradient entry at rtol 1e-5."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import graphsage_reddit
    from repro_torch.distributed.gnn_placement import assemble_halo_batch, halo_batch
    from repro_torch.models import gnn
    from repro_torch.train.loop import value_and_grad
    from repro_torch.tree import tree_leaves, tree_map

    cfg = graphsage_reddit.full_config()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((graph.n, cfg.d_in), dtype=np.float32)
    labels = (block % cfg.n_classes).astype(np.int32)
    t0 = time.perf_counter()
    hb = halo_batch(graph, block, dist.get_world_size(), x, labels)
    t_build = time.perf_counter() - t0
    whole = assemble_halo_batch(hb)
    hbatch = {k: torch.from_numpy(v).cuda() for k, v in hb.items()
              if k not in ("node", "n_shards")}
    wbatch = {k: torch.from_numpy(v).cuda() for k, v in whole.items()}
    params = tree_map(lambda t: t.cuda(), gnn.sage_init(torch.Generator().manual_seed(0), cfg))

    def halo(p, b):
        return gnn.sage_fullgraph_halo_loss(p, b, cfg, mesh, ("data",))

    def plain(p, b):
        return gnn.sage_loss(p, b, cfg)

    h_loss, h_grads = value_and_grad(halo, params, hbatch)
    w_loss, w_grads = value_and_grad(plain, params, wbatch)
    _, w_again = value_and_grad(plain, params, wbatch)
    check(bool(torch.isfinite(h_loss)), "halo loss is not finite")
    check(abs(float(h_loss) - float(w_loss)) <= 1e-5 * abs(float(w_loss)),
          f"halo loss {float(h_loss)!r} against sage_loss {float(w_loss)!r}")
    rel = max(float((a - b).norm() / b.norm()) for a, b in zip(tree_leaves(h_grads),
                                                                tree_leaves(w_grads)))
    noise = max(float((a - b).norm() / b.norm()) for a, b in zip(tree_leaves(w_again),
                                                                  tree_leaves(w_grads)))
    h_ms = wall_ms(lambda: value_and_grad(halo, params, hbatch))
    w_ms = wall_ms(lambda: value_and_grad(plain, params, wbatch))
    # the same in float64: the atomics' rounding falls below the check
    d64 = lambda t: t.double() if t.is_floating_point() else t  # noqa: E731
    p64 = tree_map(d64, params)
    l64, g64 = value_and_grad(halo, p64, tree_map(d64, hbatch))
    m64, n64 = value_and_grad(plain, p64, tree_map(d64, wbatch))
    check(abs(float(l64) - float(m64)) <= 1e-5 * abs(float(m64)),
          f"float64 halo loss {float(l64)!r} against sage_loss {float(m64)!r}")
    worst = 0.0
    for a, b in zip(tree_leaves(g64), tree_leaves(n64)):
        check(torch.allclose(a, b, rtol=1e-5, atol=1e-9 * float(b.abs().max())),
              f"float64 halo gradient differs from sage_loss's by {max_diff(a, b)}")
        worst = max(worst, float(((a - b).abs() / b.abs().clamp(min=1e-300)).max()))
    hf = hb["frontier_own"].shape[0]
    e = int(hb["edge_mask"].sum())
    via = int((hb["edge_src"][hb["edge_mask"] > 0] >= hb["x"].shape[0]).sum())
    log(f"[mesh] sage_fullgraph_halo_loss at graphsage-reddit's full width on phase 22's "
        f"placement ({graph.n} nodes, {int(block.max()) + 1} BuffCut blocks, shard-major) on "
        f"{dist.get_world_size()} rank: frontier {hf} rows ({hf / graph.n:.4f} of the nodes; "
        f"each layer's gather moves {hf * cfg.d_hidden * 4} B at d_hidden against "
        f"{graph.n * cfg.d_hidden * 4} B for the whole node state), {via} of {e} messages "
        f"through the frontier; float32: loss {float(h_loss):.6f} against sage_loss "
        f"{float(w_loss):.6f} on the assembled graph (difference "
        f"{abs(float(h_loss) - float(w_loss)):.3g}), gradients {rel:.3g} of a leaf's norm "
        f"apart at most, sage_loss against a rerun of itself {noise:.3g} (index_add's float "
        f"atomics and the frontier's other summation order); float64: loss difference "
        f"{abs(float(l64) - float(m64)):.3g}, every gradient entry within rtol 1e-5 (largest "
        f"relative difference {worst:.3g}); value_and_grad {h_ms:.3f} ms against {w_ms:.3f} "
        f"ms (float32); halo_batch built on the host in {t_build:.3f} s")


# phase 28: each module's cold import, timed in this many fresh interpreters
# (torch once: its ~7 s on the card's host is context, not a check)
QUICKSTART_IMPORTS = {"repro_torch.api": 3, "repro_torch.api.cli": 3, "torch": 1}


def port_env() -> dict:
    """The environment of a child that runs the port from this checkout."""
    import os

    return {**os.environ, "PYTHONPATH": str(ROOT / "src")}


def cold_import_s(module: str) -> tuple[float, bool]:
    """Seconds to import `module` in a fresh interpreter, and whether torch
    was loaded after it."""
    code = ("import sys, time\nt0 = time.perf_counter()\n"
            f"import {module}\n"
            "print(time.perf_counter() - t0, 'torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=port_env(), timeout=120)
    check(out.returncode == 0, f"importing {module} failed: {out.stderr[-2000:]}")
    dt, loaded = out.stdout.split()[-2:]
    return float(dt), loaded == "True"


def phase_quickstart() -> dict:
    """Phase 28: `examples/quickstart_torch.py` on the card as a user runs
    it, its BuffCut run in process against host `sparse` with the launches
    counted, the linter's verb, and the cold import of the front door.
    Returns the kernels' launches of the in-process run."""
    import importlib.util

    import numpy as np
    import torch

    from repro_torch.api import partition
    from repro_torch.kernels import ell_histogram as eh

    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qs)

    # the script as a user runs it: no device flag, so on the card
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "quickstart_torch.py")],
                         capture_output=True, text=True, cwd=ROOT, env=port_env(), timeout=600)
    t_script = time.perf_counter() - t0
    lines = out.stdout.splitlines()
    check(out.returncode == 0, f"quickstart_torch.py exited {out.returncode}: "
                               f"{out.stderr[-3000:]}")
    check(lines[-2:] == ["device=cuda (5 runs)", "OK"],
          f"quickstart_torch.py did not end with its device line and OK: {lines[-3:]}")
    for line in lines:
        log(f"[quickstart] {line}")
    log(f"[quickstart] python examples/quickstart_torch.py on the card: exit 0 in "
        f"{t_script:.1f} s (a fresh process: torch import and kernel load included)")

    # the buffcut run in process: its launches counted, labels against host sparse
    inputs, shapes = {}, []
    zero_launches()
    with recording_histogram(inputs, shapes):
        t0 = time.perf_counter()
        card = partition(qs.SOURCE, driver="buffcut", **qs.OPTS)
        t_card = time.perf_counter() - t0
    launches = read_launches()
    t0 = time.perf_counter()
    host = partition(qs.SOURCE, driver="buffcut", device="cpu", engine="sparse", **qs.OPTS)
    t_host = time.perf_counter() - t0
    check(card.provenance["device"] == "cuda" and card.provenance["engine"] == "auto",
          f"the quickstart's run did not take the card's default: {card.provenance['device']}, "
          f"{card.provenance['engine']}")
    check(np.array_equal(card.labels, host.labels),
          "the quickstart's buffcut labels on the card differ from host sparse's")
    check(card.cut_ratio == host.cut_ratio, "the quickstart's cut differs from host sparse's")
    check(launches["ell_histogram"] > 0, "the quickstart's buffcut run launched no "
                                         "ell_histogram kernel (auto should route to ell)")
    largest = max(inputs, key=lambda s: s[0] * s[2])
    blk, wts = inputs[largest]
    got = eh.block_histogram(blk, wts, largest[2])
    want = eh.ell_histogram_plain(blk, wts, largest[2])
    check(torch.equal(got, want), f"ell_histogram differs from its plain version on the "
                                  f"quickstart's input {largest}")
    log(f"[quickstart] buffcut at the quickstart's OPTS in process: auto on cuda {t_card:.3f} s, "
        f"sparse on the host {t_host:.3f} s, labels bit-equal, cut_ratio "
        f"{card.cut_ratio:.6f}, {card.stats.n_batches} batches; launches {launches}; "
        f"(B, W, k) per call {sorted(Counter(shapes).items())}; ell_histogram on the largest "
        f"{largest} equal to its plain version bit for bit")

    # the linter's verb, through `python -m repro_torch` as a user runs it
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch", "analyze", "--format", "json"],
                         capture_output=True, text=True, cwd=ROOT, env=port_env(), timeout=300)
    t_lint = time.perf_counter() - t0
    check(out.returncode == 0, f"python -m repro_torch analyze exited {out.returncode}: "
                               f"{out.stdout[-2000:]}{out.stderr[-2000:]}")
    report = json.loads(out.stdout)
    check(report["counts"]["new"] == 0, f"the linter found new violations: {report['counts']}")
    log(f"[quickstart] python -m repro_torch analyze --format json: exit {out.returncode}, "
        f"counts {report['counts']}, {report['files']} files, {t_lint:.2f} s with the "
        f"interpreter's start")

    # cold imports: the front door loads no torch
    for module, repeats in QUICKSTART_IMPORTS.items():
        times = []
        for _ in range(repeats):
            dt, loaded = cold_import_s(module)
            times.append(dt)
            if module != "torch":
                check(not loaded, f"importing {module} loaded torch")
        log(f"[quickstart] cold `import {module}` in a fresh interpreter: "
            f"{', '.join(f'{t:.4f}' for t in times)} s"
            + ("" if module == "torch" else "; torch not in sys.modules after it"))
    log(f"[quickstart] on {gpu_name_and_limit()}")
    return launches


def main(argv: list[str] | None = None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build, then time fennel_gain alone, the initial sweep on its path "
                         "(phase 6's stage split, phase 13's times) and the swa_attention "
                         "wrapper's host time; prints no result line")
    ap.add_argument("--src", type=Path, default=None,
                    help="with --kernels-only: another tree's src; its fennel_gain.cu sweep is "
                         "built beside this tree's and the two are timed in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails in a directory without the port)

    # the phases call the legacy driver functions beside the API on purpose
    warnings.filterwarnings("ignore", message=r".* is deprecated; call repro_torch\.api",
                            category=DeprecationWarning)
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
        other = other_sweep(args.src) if args.src is not None else None
        fennel_time(*FENNEL_SHAPES[0], FENNEL_GAMMAS[1], profile=True)
        coarsest = timed("profile", phase_profile, 1024)
        sweep_time(coarsest, plain=False, profile=True, other=other)
        if other is not None:
            sweep_turns(other, coarsest)
        swa_host()
        fennel_large_k()
        swa_general_time()
        log(f"[env] kernels only: total {time.perf_counter() - t_start:.1f} s")
        print(gpu_name_and_limit())
        return 0
    hist = timed("kernels/ell_histogram", phase_kernels)
    swa = timed("kernels/swa_attention", phase_swa_kernel)
    timed("parity", phase_parity)
    hist["max_abs_err"] = max(hist["max_abs_err"], timed("auto", phase_auto, AUTO_SIDE))
    side = 1024
    hist["launches"], sweeps, full_block, full_stats, full_res = timed("full", phase_full, side)
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
    path, disk = timed("disk", phase_disk, side, full_block, full_stats)
    crash = timed("crash", phase_crash, path, *disk[2][:2])
    restream = timed("restream", phase_restream, path, side, *disk[2][:2])
    shard, shard_disk, reconcile = timed("shard", phase_shard, side, full_stats)
    served = timed("serve partition", phase_serve_partition, side, full_res)
    api = timed("api", phase_api, path, side, full_res)
    Path(path).unlink()
    gnn_launches, gnn_g, gnn_block = timed("gnn", phase_gnn)
    lm = [timed("moe_serve", phase_moe_serve), timed("moe_parity", phase_moe_parity),
          timed("train_lm", phase_train_lm), timed("train_dlrm", phase_train_dlrm)]
    meshed = timed("mesh", phase_mesh, gnn_g, gnn_block)
    log(f"[kernels] launches of phases 16-21 beside phase 5's (the kernels line): "
        f"ell_histogram {hist['launches']}; disk {disk[2][2]}, resume "
        f"{crash[0]}, restream {restream[0]}, shard {shard[0]}, shard from disk "
        f"{shard_disk[0]}, reconcile {reconcile[0]}, serve {served[0]}, CLI "
        f"{api['cli']['ell_histogram']}, heistream {api['heistream']['ell_histogram']}; "
        f"fennel_sweep {sweeps}; disk {disk[2][3]}, resume {crash[1]}, "
        f"restream {restream[1]}, shard {shard[1]}, shard from disk {shard_disk[1]}, "
        f"reconcile {reconcile[1]}, serve {served[1]}, CLI {api['cli']['fennel_sweep']}, "
        f"heistream {api['heistream']['fennel_sweep']}; phase 22 (the GNN placement): "
        f"ell_histogram {gnn_launches}, added to the kernels line")
    hist["launches"] += gnn_launches
    for entry, name in ((hist, "ell_histogram"), (swa, "swa_attention"), (bag, "embedding_bag"),
                        (fennel, "fennel_gain"), (sweep, "fennel_sweep")):
        entry["launches"] += sum(counts[name] for counts in lm)
    log(f"[kernels] launches of phases 23-26 (moe_serve, moe_parity, train_lm, train_dlrm), "
        f"added to the kernels line: {lm}")
    for entry, name in ((hist, "ell_histogram"), (swa, "swa_attention"), (bag, "embedding_bag"),
                        (fennel, "fennel_gain"), (sweep, "fennel_sweep")):
        entry["launches"] += meshed[name]
    log(f"[kernels] launches of phase 27 (mesh: the decode cell's swa_attention, the DLRM "
        f"cells' embedding_bag), added to the kernels line: {meshed}")
    quick = timed("quickstart", phase_quickstart)
    for entry, name in ((hist, "ell_histogram"), (swa, "swa_attention"), (bag, "embedding_bag"),
                        (fennel, "fennel_gain"), (sweep, "fennel_sweep")):
        entry["launches"] += quick[name]
    log(f"[kernels] launches of phase 28 (quickstart: the in-process buffcut run), added to "
        f"the kernels line: {quick}")
    log(f"[env] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [hist, swa, bag, fennel, sweep]}))
    print(gpu_name_and_limit())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
