"""Run one cell of the port's benchmark and print its result line.

    python cellbench/run.py --workload rgg_2e20.heistream --seed 7 --seconds 51 --trace 0

From the root of a checkout.  The cell (`BENCHMARK.json`) names a
configuration (a graph generator and the partitioner's settings) and a
traffic mix (the driver, the stream order, the spans).  A run makes the
graph from the seed, warms the driver's path, then partitions the whole
graph through `repro_torch.api.partition` in jobs back to back for
`--seconds`: a job starts while the time gone plus the longest job so far
fits.  With `--trace 1` the first job of the window runs under the
profiler and the run reports the per-layer metrics; otherwise the
end-to-end ones.  Once the window has closed, every job's labels are held
against the plain reference (`cellbench/reference/`).  The last line of
standard output is the result's JSON; the compared numbers, each with its
limit, end standard error and the line.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "cellbench"
BANNED = ("jax", "jaxlib", "flax", "repro")


def set_env() -> None:
    """Caches inside the checkout at fixed paths, few host threads, and no
    JAX behind any library the program loads."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")


def log(msg: str) -> None:
    print(f"cellbench: {msg}", file=sys.stderr, flush=True)


def banned_modules(names=None) -> list:
    """Top-level names of `names` (sys.modules by default) that the
    benchmark must not load, each compared whole."""
    return sorted({name.split(".")[0] for name in (sys.modules if names is None else names)}
                  & set(BANNED))


def driver_config(cell, device: str):
    """The program's `DriverConfig` from the configuration and the traffic."""
    from repro_torch.api import (
        BuffCutConfig,
        DriverConfig,
        MultilevelConfig,
        PipelineConfig,
        VectorizedConfig,
    )

    ml = MultilevelConfig(**{**cell.config["multilevel"], "device": device})
    bc = BuffCutConfig(**cell.config["buffcut"], ml=ml)
    extra = dict(cell.traffic.get("driver_params", {}))
    if "pipeline" in extra:
        extra["pipeline"] = PipelineConfig(**extra["pipeline"])
    if "vectorized" in extra:
        extra["vectorized"] = VectorizedConfig(**extra["vectorized"])
    return DriverConfig(driver=cell.traffic["driver"], buffcut=bc, **extra)


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: float = T_START) -> dict:
    """Set up, run the window, judge it; the result as a dict."""
    import numpy as np
    import torch

    from cellbench.harness import graphs, judge, spans, spec
    from cellbench.harness import trace as tracing

    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import list_partitioners, partition
    from repro_torch.device import preflight
    from repro_torch.graphs.csr import CSRGraph

    tr = cell.traffic
    if tr["driver"] not in list_partitioners():
        raise ValueError(f"driver {tr['driver']!r} is none of {list_partitioners()}")
    if tr["order"] not in graphs.ORDERS:
        raise ValueError(f"order {tr['order']!r} is none of {graphs.ORDERS}")
    reference = spec.reference(tr["driver"])
    on_card = device.startswith("cuda")

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize()

    # ---- set-up: kernels, the graph, the warm-up on the cell's own path
    preflight(device)
    log(f"kernels ready at {time.perf_counter() - t_start:.3f} s")
    t0 = time.perf_counter()
    graph = graphs.stream_order(graphs.make_graph(cell.config, seed, device), tr["order"],
                                seed, device)
    if on_card:
        torch.cuda.empty_cache()
    log(f"graph n={graph.n} m={graph.m} ({tr['order']} order) in "
        f"{time.perf_counter() - t0:.3f} s")
    g = CSRGraph(graph.indptr, graph.indices, graph.edge_w, graph.node_w)
    dc = driver_config(cell, device)
    rec = spans.Spans()
    undo = spans.install(tr, rec, kernels=trace)
    try:
        warm = []
        for _ in range(int(tr["warmup_jobs"])):
            t0 = time.perf_counter()
            partition(g, dc)
            sync()
            warm.append(time.perf_counter() - t0)
        log("warm-up jobs " + " ".join(f"{w:.3f}" for w in warm))
        rec.clear()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start

        # ---- the window: whole jobs back to back
        jobs, results = [], []
        trace_path = CACHE / "trace.json"
        w0 = time.perf_counter()
        while not jobs or time.perf_counter() - w0 + max(j.wall_s for j in jobs) <= seconds:
            traced = trace and not jobs
            nb = len(rec.batches)
            if traced:
                rec.tracing = True
                done: list = []
                with tracing.profiled(trace_path, done):
                    j0 = time.perf_counter()
                    res = partition(g, dc)
                    sync()
                rec.tracing = False
                wall = done[0] - j0
            else:
                j0 = time.perf_counter()
                res = partition(g, dc)
                sync()
                wall = time.perf_counter() - j0
            st = res.stats
            jobs.append(types.SimpleNamespace(
                n=graph.n, wall_s=wall, traced=traced, batches=rec.batches[nb:],
                runtime_s=st.runtime_s, ml_time_s=st.ml_time_s, n_batches=st.n_batches,
                provenance_runtime_s=res.provenance["runtime_s"]))
            results.append(res)
        peak = torch.cuda.max_memory_allocated() if on_card else None
        log(f"window {time.perf_counter() - w0:.3f} s: jobs "
            + " ".join(f"{j.wall_s:.3f}" for j in jobs))
    finally:
        undo()
    checked = [(r.labels, r.cut_weight) for r in results]
    del results, res
    if on_card:
        torch.cuda.empty_cache()
    trace_summary = (tracing.read_trace(trace_path, spans.span_names(tr)) if trace else None)

    # ---- the judge: the plain reference on the same graph
    part, ml = cell.config["buffcut"], cell.config["multilevel"]
    t0 = time.perf_counter()
    want = reference.partition(graph, part, ml)
    log(f"reference {time.perf_counter() - t0:.3f} s")
    cap = reference.l_max(float(graph.node_w.astype(np.float64).sum()), int(part["k"]),
                          float(part["eps"]))
    checks, failed = judge.judge(graph, want, checked, int(part["k"]), cap)

    # ---- the metrics this cell reports in this kind of run
    untraced = [j for j in jobs if not j.traced] or jobs
    ctx = types.SimpleNamespace(jobs=untraced, setup_s=setup_s, peak_bytes=peak,
                                trace=trace_summary, launches=rec.launches)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(cell.bench_dir, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak or 0)}
    out = {"correct": failed == 0, "attempted": len(jobs), "failed": failed,
           "metrics": metrics, "device": dev}
    if trace_summary is not None:
        dev["busy_s"] = trace_summary.busy_s
        dev["window_s"] = trace_summary.window_s
        out["breakdown"] = {"device_ops": tracing.top(trace_summary.rows),
                            "idle_gaps": tracing.top(trace_summary.gaps)}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_env()
    sys.path.insert(0, str(ROOT))
    from cellbench.harness import spec, yardstick

    cell = spec.load_cell(ROOT / "BENCHMARK.json", args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"cellbench: {args.workload} needs {cell.chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    print(f"cellbench: {args.workload} seed {args.seed} on {yardstick.power_limit()}",
          file=sys.stderr)
    out = run(cell, args.seed, args.seconds, bool(args.trace))
    banned = banned_modules()
    if banned:
        print(f"cellbench: the run loaded {banned}; the port's benchmark loads no JAX and "
              "not the JAX package", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
