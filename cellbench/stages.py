"""The stage split of a cell's batches, read from the program's own spans
(`repro_torch.tracing`).  The benchmark's runs do not read these spans
yet: `run.py` would have to switch the tracer on and hand its records to
the metrics, and `harness/trace.py` reduce its ranges (PERF.md §7).

    python3 cellbench/stages.py --workload rgg_2e20.heistream --seed 7 --pairs 3

From the root of a checkout, on a card (`--device cpu` runs it at any
size on the host).  The cell is set up as `run.py` sets it up: the graph
from the seed, the traffic mix's warm-up jobs.  Then `--pairs` pairs of
whole jobs, one with the tracer off and one with it on, in alternating
order, and two jobs under the profiler with the tracer on, its
`record_function` ranges off and then on.  The last line of standard
output is one JSON object:

- `per_batch`: over the tracer-on jobs, each span's milliseconds a batch
  (`<span>_ms`), the host syncs a batch (`vcycle.syncs`), the bytes
  uploaded a batch (`vcycle.h2d_mib`); the driver's own `vcycle_ms` and
  `batch_model_ms` of the same jobs (as the benchmark's metrics of those
  names read them), and what is left of each after its stages;
- `overhead`: nodes/s of the tracer-off and tracer-on jobs;
- `traced`: the profiled job with ranges on: its window and busy seconds,
  the card's idle milliseconds a batch inside each span name, the
  host-to-device copies' device seconds and the rate they imply; and the
  wall seconds of the profiled jobs with ranges off and on;
- `labels_equal`: every job gave the labels of the first.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BATCH = "driver.batch"
VCYCLE_STAGES = ("vcycle.pack", "vcycle.coarsen", "vcycle.initial", "vcycle.refine",
                 "vcycle.fetch")
MODEL_STAGES = ("batch_model.gather", "batch_model.aux", "batch_model.csr")
H2D_ROW = "Memcpy HtoD"


def per_batch(records: list, stats: list) -> dict:
    """Each span name's ms a batch, syncs and uploaded MiB a batch, from the
    records of whole jobs; `stats` are those jobs' `StreamStats`."""
    batches = sum(r.name == BATCH for r in records)
    if not batches:
        return {}
    out: dict = {}
    for r in records:
        key = f"{r.name}_ms"
        out[key] = out.get(key, 0.0) + (r.end_ns - r.start_ns) * 1e-6 / batches
    out["vcycle.syncs"] = sum(r.name == "vcycle.sync" for r in records) / batches
    out["vcycle.h2d_mib"] = sum(r.counts.get("h2d_bytes", 0) for r in records) / batches / 2**20
    n_batches = sum(s.n_batches for s in stats)
    out["vcycle_ms"] = sum(s.ml_time_s for s in stats) / n_batches * 1e3
    out["batch_model_ms"] = sum(s.runtime_s - s.ml_time_s for s in stats) / n_batches * 1e3
    out["vcycle_ms_less_stages"] = out["vcycle_ms"] - sum(
        out.get(f"{s}_ms", 0.0) for s in VCYCLE_STAGES)
    out["batch_model_ms_less_stages"] = out["batch_model_ms"] - sum(
        out.get(f"{s}_ms", 0.0) for s in MODEL_STAGES)
    return out


def span_idle(events: list, exclude=("job",)) -> dict:
    """{name: [device-idle seconds inside the spans of that name, spans]}
    over the `user_annotation` ranges of the job's thread (names in
    `exclude` left out), from a Chrome trace's events in microseconds.
    Idle is the job's time with no kernel, copy or set running, as
    `harness.trace.reduce_events` reckons it."""
    import bisect

    from cellbench.harness import trace

    job = next(e for e in events if e.get("name") == trace.JOB
               and e.get("cat") == "user_annotation")
    j0, j1, tid = float(job["ts"]), float(job["ts"]) + float(job["dur"]), job["tid"]
    dev = [(max(float(e["ts"]), j0), min(float(e["ts"]) + float(e.get("dur", 0.0)), j1))
           for e in events if e.get("ph") == "X" and e.get("cat") in trace.DEVICE_CATS
           and float(e["ts"]) < j1 and float(e["ts"]) + float(e.get("dur", 0.0)) > j0]
    idle, t = [], j0
    for s, e in trace.merged(dev):
        if s > t:
            idle.append((t, s))
        t = max(t, e)
    if t < j1:
        idle.append((t, j1))
    starts = [s for s, _ in idle]
    before = [0.0]                      # idle time before each idle stretch
    for s, e in idle:
        before.append(before[-1] + e - s)

    def idle_until(x: float) -> float:
        i = bisect.bisect_right(starts, x)
        return before[i] - (max(idle[i - 1][1] - x, 0.0) if i else 0.0)

    out: dict = {}
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("tid") == tid
                and e["name"] not in exclude):
            s, f = max(float(e["ts"]), j0), min(float(e["ts"]) + float(e["dur"]), j1)
            row = out.setdefault(e["name"], [0.0, 0])
            row[0] += max(idle_until(f) - idle_until(s), 0.0) * 1e-6
            row[1] += 1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--benchmark", type=Path, default=ROOT / "BENCHMARK.json",
                    help="a benchmark file whose cellbench/ lies beside it")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from cellbench import run as bench_run

    bench_run.set_env()
    import numpy as np
    import torch

    from cellbench.harness import graphs, spec, trace
    from repro_torch import tracing
    from repro_torch.api import partition
    from repro_torch.device import preflight
    from repro_torch.graphs.csr import CSRGraph

    cell = spec.load_cell(args.benchmark, args.workload, args.benchmark.parent / "cellbench")
    on_card = args.device.startswith("cuda")
    preflight(args.device)
    graph = graphs.stream_order(graphs.make_graph(cell.config, args.seed, args.device),
                                cell.traffic["order"], args.seed, args.device)
    g = CSRGraph(graph.indptr, graph.indices, graph.edge_w, graph.node_w)
    dc = bench_run.driver_config(cell, args.device)

    def job():
        t0 = time.perf_counter()
        res = partition(g, dc)
        if on_card:
            torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    for _ in range(int(cell.traffic["warmup_jobs"])):
        job()
    first = None
    walls: dict = {"off": [], "on": []}
    records, stats = [], []
    same = True
    try:
        for i in range(args.pairs):
            for mode in (("off", "on") if i % 2 == 0 else ("on", "off")):
                (tracing.enable if mode == "on" else tracing.disable)()
                res, wall = job()
                tracing.disable()
                walls[mode].append(wall)
                if mode == "on":
                    records += tracing.drain()
                    stats.append(res.stats)
                first = res.labels if first is None else first
                same &= bool(np.array_equal(res.labels, first))
        traced: dict = {"profiled_wall_s": {}}
        path = bench_run.CACHE / "stages_trace.json"
        for ranges in (False, True):
            tracing.enable()
            tracing.ranges(ranges)
            done: list = []
            with trace.profiled(path, done):
                j0 = time.perf_counter()
                res = partition(g, dc)
                if on_card:
                    torch.cuda.synchronize()
            tracing.ranges(False)
            tracing.disable()
            traced_records = tracing.drain()
            same &= bool(np.array_equal(res.labels, first))
            traced["profiled_wall_s"]["ranges" if ranges else "no_ranges"] = done[0] - j0
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        path.unlink()
    finally:
        tracing.disable()
        tracing.ranges(False)

    t = trace.reduce_events(events, set())
    batches = sum(r.name == BATCH for r in traced_records)
    idle = span_idle(events)
    h2d_s = sum(v[0] for name, v in t.rows.items() if name.startswith(H2D_ROW))
    h2d_bytes = sum(r.counts.get("h2d_bytes", 0) for r in traced_records)
    traced.update(
        window_s=t.window_s, busy_s=t.busy_s, batches=batches,
        idle_ms_per_batch={name: v[0] / batches * 1e3 for name, v in sorted(idle.items())},
        h2d_device_s=h2d_s, h2d_mib=h2d_bytes / 2**20,
        h2d_gb_per_s=h2d_bytes / h2d_s / 1e9 if h2d_s else None)
    out = {"workload": args.workload, "seed": args.seed, "n": graph.n,
           "per_batch": per_batch(records, stats),
           "overhead": {mode: {"nodes_per_s": graph.n * len(w) / sum(w), "walls_s": w}
                        for mode, w in walls.items()},
           "traced": traced, "labels_equal": same}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
