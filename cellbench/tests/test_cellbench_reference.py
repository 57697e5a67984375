"""The plain reference against the program at small sizes on the CPU: the
same labels and cut as `repro_torch.api.partition(..., driver="heistream")`
on both host and device engines, and the comparison failing a perturbed
label and the configuration's control."""
from __future__ import annotations

import json
import math

import numpy as np
import pytest

from cellbench import control as bench_control
from cellbench.harness import graphs, judge
from cellbench.reference import heistream as ref
from cellbench.tests._cells import ROOT, small_cell

ML = json.loads((ROOT / "cellbench/configs/rgg_2e20.json").read_text())["multilevel"]
INIT = (0.57, 0.19, 0.19, 0.05)
CASES = {
    "rgg": (lambda: graphs.rgg(1 << 12, 0.55, 21), 8, 512),
    "rgg-random": (lambda: graphs.stream_order(graphs.rgg(1 << 12, 0.55, 22), "random", 22),
                   8, 512),
    "kronecker": (lambda: graphs.kronecker(11, 16, INIT, 23), 16, 256),
}


def port_partition(g: graphs.Graph, k: int, delta: int, engine: str):
    from repro_torch.api import BuffCutConfig, DriverConfig, MultilevelConfig, partition
    from repro_torch.graphs.csr import CSRGraph

    ml = MultilevelConfig(**{**ML, "engine": engine, "device": "cpu"})
    cfg = BuffCutConfig(k=k, eps=0.03, buffer_size=4 * delta, batch_size=delta, ml=ml)
    return partition(CSRGraph(*g), DriverConfig(driver="heistream", buffcut=cfg))


@pytest.mark.parametrize("engine", ["sparse", "torch"])
@pytest.mark.parametrize("case", list(CASES))
def test_reference_equals_the_program(case, engine):
    make, k, delta = CASES[case]
    g = make()
    res = port_partition(g, k, delta, engine)
    want = ref.partition(g, {"k": k, "eps": 0.03, "batch_size": delta, "gamma": 1.5}, ML)
    assert np.array_equal(res.labels, want)
    assert res.cut_weight == judge.edge_cut(g, want)
    cap = ref.l_max(float(g.n), k, 0.03)
    checks, failed = judge.judge(g, want, [(res.labels, res.cut_weight)], k, cap)
    assert failed == 0 and checks["label_mismatch"]["value"] == 0
    assert checks["load_over_cap"]["value"] <= 1.0


def test_a_perturbed_label_fails_the_comparison():
    make, k, delta = CASES["rgg"]
    g = make()
    want = ref.partition(g, {"k": k, "eps": 0.03, "batch_size": delta, "gamma": 1.5}, ML)
    cap = ref.l_max(float(g.n), k, 0.03)
    bad = want.copy()
    bad[123] = (bad[123] + 1) % k
    checks, failed = judge.judge(g, want, [(want, judge.edge_cut(g, want)),
                                           (bad, judge.edge_cut(g, bad))], k, cap)
    assert failed == 1 and checks["label_mismatch"]["value"] == 1
    # a cut that is not the labels' fails too, and so does a label out of range
    checks, failed = judge.judge(g, want, [(want, judge.edge_cut(g, want) + 1)], k, cap)
    assert failed == 1 and checks["cut_gap"]["value"] == 1
    bad[7] = k
    _, failed = judge.judge(g, want, [(bad, 0.0)], k, cap)
    assert failed == 1


def test_the_lifted_cap_overloads_a_block():
    make, k, delta = CASES["kronecker"]
    g = make()
    part = {"k": k, "eps": 0.03, "batch_size": delta, "gamma": 1.5}
    want = ref.partition(g, part, ML)
    got = ref.partition(g, part, ML, cap=math.inf)
    cap = ref.l_max(float(g.n), k, 0.03)
    checks, failed = judge.judge(g, want, [(got, judge.edge_cut(g, got))], k, cap)
    assert failed == 1 and checks["load_over_cap"]["value"] > 1.0


@pytest.mark.parametrize("workload", ["rgg_2e20.heistream", "rgg_2e20.heistream_random",
                                      "rmat_2e19.heistream"])
def test_the_control_fails_every_seed(tmp_path, workload):
    cell = small_cell(tmp_path, workload)
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        (line,) = bench_control.control(cell, seed, "cpu", [cell.config["control"]])
        assert line["failed"] == 1 and line["checks"]["label_mismatch"] > 0
