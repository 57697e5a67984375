"""The frozen yardstick and the readers that use it: hand counts of the
kernels' work, the trace's reduction, and each metric from a made-up run."""
from __future__ import annotations

import types

import pytest

from cellbench.harness import spec, trace, yardstick
from cellbench.tests._cells import BENCH


def test_peaks_are_the_h100_data_sheets():
    assert yardstick.HBM_BYTES_PER_S == 3.35e12
    assert yardstick.FP32_OPS_PER_S == 67e12


@pytest.mark.parametrize("shape, nbytes", [
    ((65536, 8, 32), 65536 * 8 * 4 + 65536 * 8 * 4 + 65536 * 32 * 4),   # 12,582,912
    ((4096, 64, 4096), 4096 * 64 * 8 + 4096 * 4096 * 4),
    ((1, 1, 2), 8 + 8),
])
def test_histogram_bytes_are_the_hand_count(shape, nbytes):
    assert yardstick.hist_bytes(*shape) == nbytes


def test_the_bound_is_the_longer_of_bytes_and_operations():
    assert yardstick.hist_bytes(65536, 8, 32) == 12_582_912
    assert yardstick.bound_s(12_582_912) == pytest.approx(3.756e-6, rel=1e-3)
    assert yardstick.bound_s(0, 67e12) == pytest.approx(1.0)
    assert yardstick.sweep_steps(12072) == 12072


def events():
    """A job of 100 us: kernels at [10, 30) and [25, 40), a copy at [70, 80);
    the host in `vcycle` over [0, 60) (an op `aten::sort` in [45, 55)) and
    `batch_model` over [60, 100)."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "job", "ts": 1000.0, "dur": 100.0,
           "tid": 1},
          {"ph": "X", "cat": "user_annotation", "name": "vcycle", "ts": 1000.0, "dur": 60.0,
           "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 1045.0, "dur": 10.0, "tid": 1},
          {"ph": "X", "cat": "user_annotation", "name": "batch_model", "ts": 1060.0, "dur": 40.0,
           "tid": 1},
          {"ph": "X", "cat": "kernel", "name": "hist_kernel", "ts": 1010.0, "dur": 20.0, "tid": 7},
          {"ph": "X", "cat": "kernel", "name": "fennel_sweep_kernel<1>", "ts": 1025.0,
           "dur": 15.0, "tid": 7},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1070.0, "dur": 10.0,
           "tid": 7}]
    return ev


def test_the_trace_reduces_to_busy_time_rows_and_named_gaps():
    t = trace.reduce_events(events(), {"vcycle", "batch_model"})
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(40e-6)                 # [10, 40) and [70, 80)
    assert t.rows["hist_kernel"] == [pytest.approx(20e-6), 1]
    # idle: [0, 10) and [40, 60) in vcycle (the second's middle in
    # aten::sort), [60, 70) and [80, 100) in batch_model: the gap [40, 70)
    # is cut where vcycle ends
    assert t.gaps["vcycle"] == pytest.approx(10e-6)
    assert t.gaps["vcycle:aten::sort"] == pytest.approx(20e-6)
    assert t.gaps["batch_model"] == pytest.approx(30e-6)
    assert trace.top(t.gaps, 2)[0] == ["batch_model", pytest.approx(30e-6)]


def test_innermost_and_merged():
    assert trace.merged([(5, 6), (1, 3), (2, 4)]) == [[1, 4], [5, 6]]
    spans = [(0, 10, "a"), (2, 5, "b"), (3, 4, "c"), (6, 8, "d")]
    assert trace.innermost(spans, [1, 3.5, 4.5, 7, 9, 11]) == ["a", "c", "b", "d", "a", None]


def ctx(**kw):
    jobs = [types.SimpleNamespace(n=1000, wall_s=2.0, traced=False, runtime_s=1.9, ml_time_s=1.5,
                                  n_batches=4, provenance_runtime_s=1.95,
                                  batches=[(0.0, 0.1, 0.5)] * 9 + [(0.0, 0.1, 1.5)]),
            types.SimpleNamespace(n=1000, wall_s=3.0, traced=False, runtime_s=2.9, ml_time_s=2.5,
                                  n_batches=4, provenance_runtime_s=2.97,
                                  batches=[(0.0, 0.1, 0.5)] * 10)]
    base = dict(jobs=jobs, setup_s=12.5, peak_bytes=3 * 2**20, trace=None, launches={})
    return types.SimpleNamespace(**{**base, **kw})


def read(name, c):
    return spec.reader(BENCH, name)(c)


def test_end_to_end_readers():
    c = ctx()
    assert read("nodes_per_s", c) == pytest.approx(2000 / 5.0)
    assert read("setup_s", c) == 12.5
    assert read("peak_device_mib", c) == 3.0
    assert read("peak_device_mib", ctx(peak_bytes=None)) is None
    assert 500.0 <= read("batch_ms_p90", c) <= 1500.0


@pytest.mark.parametrize("twin", sorted(p.stem for p in (BENCH / "metrics").glob("*.random.py")))
def test_a_random_cell_twin_reads_as_its_metric(twin):
    base = twin.removesuffix(".random")
    c = ctx()
    assert read(twin, c) == read(base, c)


def test_program_span_readers():
    c = ctx()
    assert read("facade_ms", c) == pytest.approx(((1.95 - 1.9) + (2.97 - 2.9)) / 2 * 1e3)
    assert read("batch_model_ms", c) == pytest.approx((0.4 + 0.4) / 8 * 1e3)
    assert read("vcycle_ms", c) == pytest.approx(4.0 / 8 * 1e3)


def test_device_readers():
    t = trace.reduce_events(events(), {"vcycle", "batch_model"})
    launches = {"ell_histogram": [([(100, 8), (100, 8), 4], {})],
                "fennel_sweep": [([None] * 8 + [30], {})]}
    c = ctx(trace=t, launches=launches)
    assert read("device_idle", c) == pytest.approx(60.0)
    bound = yardstick.hist_bytes(100, 8, 4) / 3.35e12
    assert read("ell_histogram.roofline", c) == pytest.approx(100 * bound / 20e-6)
    assert read("fennel_sweep.ns_per_step", c) == pytest.approx(15e-6 / 30 * 1e9)
    # a kernel that did not launch reads nothing, never 0
    empty = ctx(trace=t, launches={})
    assert read("ell_histogram.roofline", empty) is None
    assert read("fennel_sweep.ns_per_step", empty) is None
    assert read("device_idle", ctx()) is None
