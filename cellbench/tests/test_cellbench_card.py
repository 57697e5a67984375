"""On the card: a small cell through the whole harness, traced, on the
CUDA kernels.  Skips where torch sees no card."""
from __future__ import annotations

import time

import pytest

from cellbench import run as bench_run
from cellbench.tests._cells import small_cell


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["rgg_2e20.heistream", "rmat_2e19.heistream"])
def test_a_small_cell_on_the_card(tmp_path, workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs the port's CUDA kernels")
    cell = small_cell(tmp_path, workload)
    out = bench_run.run(cell, 2**31 + 5, 0.5, trace=True, device="cuda",
                        t_start=time.perf_counter())
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    assert "fennel_sweep.ns_per_step" in out["metrics"]
    assert 0 < out["metrics"]["device_idle"]["value"] < 100
