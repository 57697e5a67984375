"""`cellbench/stages.py`: the card's idle time inside the program's ranges,
the per-batch stage split, and a small cell through the whole tool on the
CPU.  The program's ranges leave the trace's existing reduction as it was."""
from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import types

import pytest

from cellbench import stages
from cellbench.harness import trace
from cellbench.tests._cells import small_bench
from cellbench.tests.test_cellbench_yardstick import events


def with_program_ranges():
    """The synthetic job of `test_cellbench_yardstick.events` (idle over
    [0, 10), [40, 70) and [80, 100) us) with the program's ranges on the
    job's thread, and the device-side copy of one on the card's."""
    ev = events()
    for name, s, d in [("driver.batch", 0.0, 100.0), ("vcycle.coarsen", 0.0, 50.0),
                       ("vcycle.sync", 25.0, 20.0), ("vcycle.refine", 50.0, 10.0),
                       ("vcycle.refine", 65.0, 25.0)]:
        ev.append({"ph": "X", "cat": "user_annotation", "name": name, "ts": 1000.0 + s,
                   "dur": d, "tid": 1})
    ev.append({"ph": "X", "cat": "gpu_user_annotation", "name": "vcycle.coarsen",
               "ts": 1010.0, "dur": 30.0, "tid": 7})
    return ev


def test_program_ranges_leave_the_reduction_as_it_was():
    names = {"vcycle", "batch_model"}
    want, got = trace.reduce_events(events(), names), trace.reduce_events(with_program_ranges(),
                                                                          names)
    assert (got.window_s, got.busy_s, got.rows, got.gaps) == (
        want.window_s, want.busy_s, want.rows, want.gaps)


def test_idle_time_inside_each_range():
    idle = stages.span_idle(with_program_ranges(), exclude=("job", "vcycle", "batch_model"))
    assert set(idle) == {"driver.batch", "vcycle.coarsen", "vcycle.sync", "vcycle.refine"}
    assert idle["driver.batch"] == [pytest.approx(60e-6), 1]
    assert idle["vcycle.coarsen"] == [pytest.approx(20e-6), 1]     # [0, 10), [40, 50)
    assert idle["vcycle.sync"] == [pytest.approx(5e-6), 1]         # [40, 45)
    assert idle["vcycle.refine"] == [pytest.approx(25e-6), 2]      # [50, 60); [65, 70), [80, 90)


def rec(name, start_ms, end_ms, **counts):
    return types.SimpleNamespace(name=name, start_ns=int(start_ms * 1e6),
                                 end_ns=int(end_ms * 1e6), counts=counts)


def test_per_batch_split_and_residuals():
    records = []
    for b in range(2):
        t = 100.0 * b
        records += [rec("batch_model.gather", t, t + 4), rec("batch_model.aux", t + 4, t + 10),
                    rec("batch_model.csr", t + 10, t + 12),
                    rec("vcycle.pack", t + 20, t + 25, h2d_bytes=2**20),
                    rec("vcycle.coarsen", t + 25, t + 40), rec("vcycle.sync", t + 38, t + 40),
                    rec("vcycle.initial", t + 40, t + 45, h2d_bytes=2**19),
                    rec("vcycle.refine", t + 45, t + 60), rec("vcycle.fetch", t + 60, t + 61),
                    rec("vcycle.sync", t + 60, t + 61), rec("driver.batch", t, t + 62)]
    stats = [types.SimpleNamespace(n_batches=2, ml_time_s=0.084, runtime_s=0.114)]
    out = stages.per_batch(records, stats)
    assert out["batch_model.aux_ms"] == pytest.approx(6.0)
    assert out["vcycle.coarsen_ms"] == pytest.approx(15.0)
    assert out["vcycle.sync_ms"] == pytest.approx(3.0)
    assert out["vcycle.syncs"] == 2.0
    assert out["vcycle.h2d_mib"] == pytest.approx(1.5)
    assert out["vcycle_ms"] == pytest.approx(42.0)
    assert out["vcycle_ms_less_stages"] == pytest.approx(42.0 - 41.0)
    assert out["batch_model_ms"] == pytest.approx(15.0)
    assert out["batch_model_ms_less_stages"] == pytest.approx(15.0 - 12.0)
    assert stages.per_batch([], stats) == {}


def test_a_small_cell_through_the_tool_on_the_cpu(tmp_path, monkeypatch):
    small_bench(tmp_path)
    monkeypatch.setattr(sys, "path", list(sys.path))     # the tool sets both up as run.py does
    monkeypatch.setattr(os, "environ", dict(os.environ))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = stages.main(["--workload", "rgg_2e20.heistream", "--seed", str(2**31 + 3),
                          "--pairs", "1", "--device", "cpu",
                          "--benchmark", str(tmp_path / "BENCHMARK.json")])
    assert rc == 0
    out = json.loads(buf.getvalue().splitlines()[-1])
    assert out["labels_equal"] is True
    pb = out["per_batch"]
    for name in (*stages.VCYCLE_STAGES, *stages.MODEL_STAGES):
        assert pb[f"{name}_ms"] > 0
    assert pb["vcycle.syncs"] >= 1 and pb["vcycle.h2d_mib"] > 0
    # the stages lie inside the driver's V-cycle timer
    assert pb["vcycle_ms_less_stages"] >= 0
    assert out["traced"]["batches"] == 8                  # 4096 nodes / 512
    assert "vcycle.coarsen" in out["traced"]["idle_ms_per_batch"]
    assert set(out["overhead"]) == {"off", "on"}
