"""A whole run on the CPU, past the harness's look for a card, with the
timed path broken underneath: `correct` has to come out false for each
fault the cells can have.  (A cell on one chip has no exchange between
chips to leave out.)"""
from __future__ import annotations

import time

import numpy as np
import pytest

from cellbench import run as bench_run
from cellbench.tests._cells import small_cell

CELLS = ["rgg_2e20.heistream", "rgg_2e20.heistream_random", "rmat_2e19.heistream"]


def alter_an_answer(mp):
    """A label altered where the V-cycle produces it."""
    import repro_torch.core.heistream as hs

    real = hs.multilevel_partition

    def fault(g, pinned, p, loads, cfg):
        labels = real(g, pinned, p, loads, cfg)
        labels[0] = (labels[0] + 1) % p.k
        return labels
    mp.setattr(hs, "multilevel_partition", fault)


def refinement_returns_its_state(mp):
    """A step (LP refinement, every level) that returns its state unchanged."""
    import repro_torch.core.multilevel_torch as mlt

    def fault(esrc, edst, ew, nbr, wts, node_w, pinned, n, labels, loads, cap, **kw):
        return labels, loads
    mp.setattr(mlt, "_lp_refine", fault)


def half_the_batch_left_out(mp):
    """Half of each batch left out of the batch model: the second half's
    edges are dropped, so the V-cycle places those nodes blind."""
    import repro_torch.core.heistream as hs
    from repro_torch.graphs.csr import CSRGraph

    real = hs.build_batch_model

    def fault(g, bnodes, block, k):
        model = real(g, bnodes, block, k)
        m = model.graph
        rows = np.repeat(np.arange(m.n), np.diff(m.indptr))
        cols = m.indices.astype(np.int64)
        half = model.b // 2
        keep = (rows < cols) & ~((rows >= half) & (rows < model.b)) & ~(
            (cols >= half) & (cols < model.b))
        model.graph = CSRGraph.from_edges(m.n, np.stack([rows[keep], cols[keep]], 1),
                                          edge_weights=m.edge_w[keep], node_weights=m.node_w)
        return model
    mp.setattr(hs, "build_batch_model", fault)


FAULTS = [alter_an_answer, refinement_returns_its_state, half_the_batch_left_out]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_path_is_not_correct(tmp_path, monkeypatch, workload, fault):
    cell = small_cell(tmp_path, workload)
    fault(monkeypatch)
    out = bench_run.run(cell, 2**31 + 9, 0.1, trace=False, device="cpu",
                        t_start=time.perf_counter())
    assert out["correct"] is False and out["failed"] == out["attempted"] >= 1
    assert out["checks"]["label_mismatch"]["value"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_the_sound_path_is_correct(tmp_path, workload):
    cell = small_cell(tmp_path, workload)
    out = bench_run.run(cell, 2**31 + 9, 0.1, trace=False, device="cpu",
                        t_start=time.perf_counter())
    assert out["correct"] is True and out["failed"] == 0
    assert {m["name"] for m in cell.end_to_end} - {"peak_device_mib"} == set(out["metrics"])
