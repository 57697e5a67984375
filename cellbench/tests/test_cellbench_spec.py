"""BENCHMARK.json and the files it names: the contract's characters and
shapes, every part of every cell found by name, and a throwaway cell
added as new files and a new entry only."""
from __future__ import annotations

import json
import re
import time

import pytest

from cellbench import run as bench_run
from cellbench.harness import spec
from cellbench.tests._cells import BENCH, ROOT, small_bench

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "cellbench/run.py"]
    assert SPEC["paths"] == ["cellbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"] + SPEC["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_use_the_allowed_characters(entry):
    assert NAME.fullmatch(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.fullmatch(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.fullmatch(key)
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_units_sources_and_readers(metric):
    assert UNIT.fullmatch(metric["unit"]) and len(metric["unit"]) <= 16
    assert metric["better"] in ("lower", "higher")
    assert callable(spec.reader(BENCH, metric["name"]))
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert metric["moves"] in [m["name"] for m in SPEC["end_to_end"]]
        assert set(metric["workloads"]) <= set(CELLS)
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves",
                               "workloads"}


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    names = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in names
    for cell in CELLS:
        e2e = [m for m in SPEC["end_to_end"] if spec.reports(m, cell)]
        assert {"setup_s"} < {m["name"] for m in e2e}
        assert any(spec.reports(m, cell) for m in SPEC["per_layer"])


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_moves_an_end_to_end_metric_of_its_cells(metric):
    moved = next(m for m in SPEC["end_to_end"] if m["name"] == metric["moves"])
    assert metric["workloads"]
    for cell in metric["workloads"]:
        assert spec.reports(moved, cell), (metric["name"], cell)


def test_file_names_under_the_benchmark_use_name_characters():
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert all(NAME.fullmatch(part) for part in rel.split("/")), rel


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_finds_its_config_and_traffic_by_name(workload):
    cell = spec.load_cell(ROOT / "BENCHMARK.json", workload)
    entry = next(w for w in SPEC["workloads"] if w["name"] == workload)
    conf = next(c for c in SPEC["configs"] if c["name"] == entry["config"])
    assert cell.config["name"] == conf["name"]
    assert cell.config["reduced"] == conf["reduced"]
    assert set(cell.config["reduced"]) <= set(cell.config)
    assert cell.traffic == json.loads((BENCH / "traffic" / f"{entry['traffic']}.json").read_text())
    assert cell.chips == 1
    assert spec.reference(cell.traffic["driver"]).partition


def test_config_keeps_the_papers_widths():
    for conf in SPEC["configs"]:
        cfg = json.loads((ROOT / conf["file"]).read_text())
        bc = cfg["buffcut"]
        assert (bc["k"], bc["eps"], bc["buffer_size"], bc["batch_size"]) == (32, 0.03, 262144, 32768)
        assert cfg["control"] in ("rounds", "cap")


def test_a_throwaway_cell_is_new_files_and_a_new_entry(tmp_path):
    """A new configuration, traffic mix and per-layer metric, each a new file
    beside copies of the benchmark's, and entries for them; the harness runs
    the cell and reports the new metric without an edit anywhere."""
    bench = small_bench(tmp_path)
    spec_ = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cfg = json.loads((tmp_path / "cellbench/configs/rgg_2e20.json").read_text())
    cfg.update(name="rgg_tiny", n=1 << 11)
    (bench / "configs/rgg_tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic/heistream.json").read_text())
    traffic["order"] = "bfs"
    (bench / "traffic/heistream_bfs.json").write_text(json.dumps(traffic))
    (bench / "metrics/batches_per_job.py").write_text(
        "def read(ctx):\n    return sum(j.n_batches for j in ctx.jobs) / len(ctx.jobs)\n")
    spec_["configs"].append({"name": "rgg_tiny", "source": "test", "file":
                             "cellbench/configs/rgg_tiny.json", "reduced": ["n"], "why": "test"})
    spec_["workloads"].append({"name": "rgg_tiny.heistream_bfs", "config": "rgg_tiny",
                               "traffic": "heistream_bfs", "chips": 1, "why": "test"})
    spec_["per_layer"].append({"name": "batches_per_job", "unit": "batches", "better": "lower",
                               "source": "program_counter", "layer": "driver loop and batch model",
                               "moves": "nodes_per_s", "workloads": ["rgg_tiny.heistream_bfs"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec_))
    cell = spec.load_cell(tmp_path / "BENCHMARK.json", "rgg_tiny.heistream_bfs", bench)
    out = bench_run.run(cell, 3, 0.1, trace=True, device="cpu", t_start=time.perf_counter())
    assert out["correct"] and out["attempted"] >= 1
    assert out["metrics"]["batches_per_job"]["value"] == 4.0   # 2048 nodes / 512
    assert list(out)[-1] == "checks"
