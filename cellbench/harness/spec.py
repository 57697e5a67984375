"""Finds a cell's parts by name: its entry in `BENCHMARK.json`, its
configuration's file, its traffic mix (`traffic/<name>.json`), each
metric's reader (`metrics/<name>.py`, a function `read(ctx)`) and the
reference of its driver (`reference/<driver>.py`, a function
`partition(graph, part, ml, cap=None)`).  A new cell, configuration,
traffic mix or metric is a new file and a new entry; nothing here names
one.

A reader gets `ctx` with `jobs` (the window's untraced jobs, or the
traced one alone; each has `n`, `wall_s`, `batches` as (start, V-cycle
start, end) host times, `runtime_s`, `ml_time_s`, `n_batches` and
`provenance_runtime_s`), `setup_s`, `peak_bytes` (None off a card),
`trace` (`harness.trace.Trace` of the traced job, else None) and
`launches` ({kernel span: [(argument summaries, keyword summaries)]} of
the traced job).  It returns a number, or None where it finds nothing
to read.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]           # cellbench/


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict              # the configuration's file
    traffic: dict             # the traffic mix's file
    end_to_end: list          # the BENCHMARK.json entries this cell reports
    per_layer: list
    bench_dir: Path           # where configs/, traffic/ and metrics/ live


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(benchmark: Path, workload: str, bench_dir: Path = HERE) -> Cell:
    """The cell `workload` of the benchmark file `benchmark`; the files it
    names are read relative to the file's directory, traffic mixes and
    metrics from `bench_dir`."""
    spec = load_json(benchmark)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {benchmark}; cells: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(benchmark.parent / configs[cell["config"]]["file"])
    traffic = load_json(bench_dir / "traffic" / f"{cell['traffic']}.json")
    return Cell(
        name=workload,
        chips=int(cell["chips"]),
        config=config,
        traffic=traffic,
        end_to_end=[m for m in spec["end_to_end"] if reports(m, workload)],
        per_layer=[m for m in spec["per_layer"] if reports(m, workload)],
        bench_dir=bench_dir,
    )


def reader(bench_dir: Path, name: str):
    """The `read(ctx)` function of metrics/<name>.py."""
    path = bench_dir / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"cellbench_metric_{name}", path)
    if mod_spec is None or not path.exists():
        raise FileNotFoundError(f"metric {name!r} has no reader at {path}")
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def reference(driver: str):
    """The plain reference of a driver: cellbench/reference/<driver>.py."""
    name = driver.replace("-", "_")
    try:
        return importlib.import_module(f"cellbench.reference.{name}")
    except ModuleNotFoundError as err:
        if err.name != f"cellbench.reference.{name}":
            raise
        raise LookupError(f"driver {driver!r} has no reference (cellbench/reference/"
                          f"{name}.py); a cell of it cannot be judged") from err
