"""The port's in-program spans (`repro_torch.tracing`): off they record
nothing and cost one shared object; on they nest per thread, count, and
tile a HeiStream batch into the batch model's and the V-cycle's stages,
with a `vcycle.sync` at every point where the host waits for the device;
labels are the same either way."""
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from repro_torch import tracing

ROOT = Path(__file__).resolve().parents[1]

VCYCLE_STAGES = {"vcycle.pack", "vcycle.coarsen", "vcycle.initial", "vcycle.refine",
                 "vcycle.fetch"}


@pytest.fixture
def on():
    tracing.drain()
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.ranges(False)
        tracing.drain()


def test_off_records_nothing_and_hands_out_one_shared_span():
    tracing.disable()
    tracing.drain()
    a, b = tracing.span("vcycle.pack"), tracing.span("driver.batch")
    assert a is b is tracing.NO_SPAN
    with tracing.span("vcycle.pack") as s:
        s.add("h2d_bytes", 8)
        tracing.add("h2d_bytes", 8)
    assert tracing.drain() == []


def test_spans_nest_and_counts_accumulate(on):
    with tracing.span("outer") as outer:
        with tracing.span("inner") as inner:
            inner.add("h2d_bytes", 3)
            tracing.add("h2d_bytes", 4)          # the innermost open span
        outer.add("rows", 1)
        outer.add("rows", 1)
    tracing.add("h2d_bytes", 5)                  # no span open: dropped
    recs = {r.name: r for r in tracing.drain()}
    assert set(recs) == {"outer", "inner"}
    o, i = recs["outer"], recs["inner"]
    assert o.parent == 0 and i.parent == o.id != i.id
    assert o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns
    assert i.counts == {"h2d_bytes": 7} and o.counts == {"rows": 2}
    assert o.thread == i.thread == threading.get_ident()
    assert tracing.drain() == []


def test_two_threads_keep_separate_stacks(on):
    """Both threads hold their root open while the other opens its child:
    a shared stack would parent one child to the other thread's root."""
    barrier = threading.Barrier(2, timeout=10)

    def work(tag: str) -> None:
        with tracing.span(f"{tag}.root"):
            barrier.wait()
            with tracing.span(f"{tag}.child"):
                barrier.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    recs = {r.name: r for r in tracing.drain()}
    for tag in ("a", "b"):
        root, child = recs[f"{tag}.root"], recs[f"{tag}.child"]
        assert root.parent == 0 and child.parent == root.id
        assert child.thread == root.thread
    assert recs["a.root"].thread != recs["b.root"].thread


def test_ranges_land_in_the_profiler(on):
    from torch.profiler import ProfilerActivity, profile

    tracing.ranges(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("vcycle.pack"):
            with tracing.span("vcycle.sync"):
                pass
    names = {e.name for e in prof.events()}
    assert {"vcycle.pack", "vcycle.sync"} <= names
    assert [r.name for r in tracing.drain()] == ["vcycle.sync", "vcycle.pack"]


def test_the_module_loads_no_torch():
    code = "import sys, repro_torch.tracing\nprint('torch' in sys.modules)\n"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "False"


# --------------------------------------------------------------------------
# the batch path: HeiStream with the device V-cycle on the CPU
# --------------------------------------------------------------------------

def _graph(order: str):
    from repro_torch.graphs import apply_order, grid_mesh_graph, random_order

    g = grid_mesh_graph(48)                      # 2304 nodes, 3 batches of 768
    return g if order == "natural" else apply_order(g, random_order(g, 5))


KW = dict(driver="heistream", k=8, engine="torch", device="cpu", batch_size=768,
          buffer_size=2048)


def _levels(g):
    """Per batch, (levels tried, levels kept) of the host engine's V-cycle,
    which coarsens as the device engine does."""
    from repro_torch.api import partition
    from repro_torch.core import multilevel

    per_batch, seen = [], []
    contract = multilevel.contract

    def counted(cur_g, cluster, cur_pin):
        cg, cpin, node_map = contract(cur_g, cluster, cur_pin)
        seen.append(cg.n < multilevel.MultilevelConfig().min_shrink * cur_g.n)
        return cg, cpin, node_map

    build = multilevel.multilevel_partition

    def batch(*args, **kw):
        seen.clear()
        out = build(*args, **kw)
        per_batch.append((len(seen), sum(seen)))
        return out

    import repro_torch.core.heistream as hs

    mp = pytest.MonkeyPatch()
    mp.setattr(multilevel, "contract", counted)
    mp.setattr(hs, "multilevel_partition", batch)
    try:
        partition(g, **{**KW, "engine": "sparse"})
    finally:
        mp.undo()
    return per_batch


def _children(recs, parent):
    return sorted((r for r in recs if r.parent == parent.id), key=lambda r: r.start_ns)


@pytest.mark.parametrize("order", ["natural", "random"])
def test_every_batch_is_one_tree_of_the_stages(on, order):
    from repro_torch.api import partition

    g = _graph(order)
    res = partition(g, **KW)
    recs = tracing.drain()
    roots = sorted((r for r in recs if r.parent == 0), key=lambda r: r.start_ns)
    assert [r.name for r in roots] == ["driver.batch"] * res.stats.n_batches
    levels = _levels(g)
    assert len(levels) == len(roots)
    assert any(kept for _, kept in levels)
    for root, (tried, kept) in zip(roots, levels):
        model, vcycle = _children(recs, root)
        assert (model.name, vcycle.name) == ("batch_model.run", "vcycle.run")
        assert [r.name for r in _children(recs, model)] == [
            "batch_model.gather", "batch_model.gather", "batch_model.aux", "batch_model.csr"]
        stages = _children(recs, vcycle)
        assert [r.name for r in stages] == (
            ["vcycle.pack"] + ["vcycle.coarsen"] * tried + ["vcycle.initial"]
            + ["vcycle.refine"] * (kept + 1) + ["vcycle.fetch"])
        for s in stages:
            assert vcycle.start_ns <= s.start_ns <= s.end_ns <= vcycle.end_ns
            for sync in _children(recs, s):
                assert sync.name == "vcycle.sync" and not _children(recs, sync)
        syncs = {s.id: len(_children(recs, s)) for s in stages}
        # a kept level: its node count, edge count and free count; a level
        # that does not shrink enough: its node count; the coarsest level's
        # degree count (bincount) and maximum; the labels' fetch
        want = 3 * kept + (tried - kept) + (2 if kept else 0) + 1
        assert sum(syncs.values()) == want
        assert sum(syncs[s.id] for s in stages if s.name == "vcycle.refine") == 0
        assert syncs[stages[-1].id] == 1
        # uploads: the compact CSR (node arrays and edges), then the loads
        pack = stages[0]
        n_pad = 1 << int(np.ceil(np.log2(768 + 8)))
        assert pack.counts["h2d_bytes"] >= 8 * 2 * n_pad
        initial = next(s for s in stages if s.name == "vcycle.initial")
        assert initial.counts == {"h2d_bytes": 8 * KW["k"]}


@pytest.mark.parametrize("ranges", [False, True], ids=["spans", "spans+ranges"])
def test_labels_are_the_same_with_tracing_on_and_off(ranges):
    from repro_torch.api import partition

    g = _graph("natural")
    tracing.disable()
    off = partition(g, **KW)
    tracing.enable()
    tracing.ranges(ranges)
    try:
        on_ = partition(g, **KW)
    finally:
        tracing.disable()
        tracing.ranges(False)
    assert tracing.drain()
    np.testing.assert_array_equal(off.labels, on_.labels)
    assert off.cut_weight == on_.cut_weight
