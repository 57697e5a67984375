"""The V-cycle's level-0 pack (`repro_torch.kernels.csr_pack`): the plain
version against the host pack (`CSRGraph.to_coo_padded` and
`to_ell_padded`, the tiles widened to int64) bit for bit, the compact
layout the host uploads, and the wrapper's checks, on the CPU; on a card,
the kernel against the plain version on the same cases and at the cells'
full widths, and the device V-cycle with the card pack against the host
`sparse` engine, with its counts and its peak memory.

Card tests are marked `cuda` and skip without one.  The file imports
neither jax nor the JAX package, so it runs on a machine that has only
PyTorch:  PYTHONPATH=src python -m pytest -q tests/test_torch_pack.py
"""
import numpy as np
import pytest
import torch

import repro_torch.core.multilevel_torch as mlt
from repro_torch import tracing
from repro_torch.core.batch_model import build_batch_model
from repro_torch.core.fennel import FennelParams
from repro_torch.core.multilevel import MultilevelConfig, multilevel_partition
from repro_torch.graphs import grid_mesh_graph, rmat_graph
from repro_torch.graphs.csr import CSRGraph, bucket_size
from repro_torch.kernels import csr_pack as cp


def _free(g):
    return np.full(g.n, -1, dtype=np.int64)


def _batch_model(g, k=8):
    rng = np.random.default_rng(0)
    block = np.full(g.n, -1, dtype=np.int64)
    block[:200] = rng.integers(0, k, 200)
    loads = np.bincount(block[:200], weights=g.node_w[:200], minlength=k).astype(np.float64)
    model = build_batch_model(g, np.arange(200, 420), block, k)
    p = FennelParams(k=k, n_total=float(g.node_w.sum()), m_total=g.total_edge_weight(),
                     eps=0.05)
    return model, p, loads


def _case_empty():
    g = CSRGraph.from_edges(0, np.empty((0, 2), dtype=np.int64))
    return g, _free(g), 64, 64


def _case_isolated():
    # rows 10..39 have no edge; a fractional weight survives the widening
    edges = np.array([[0, 1], [1, 2], [2, 9], [40, 49], [3, 45]])
    g = CSRGraph.from_edges(50, edges, edge_weights=np.array([1, 2.5, 0.1, 7, 3], np.float32))
    return g, _free(g), 64, 64


def _case_truncated():
    # a hub of degree 60 and a row of degree 9: both wider than 8-wide tiles
    edges = [[0, v] for v in range(1, 61)] + [[1, v] for v in range(2, 10)]
    g = CSRGraph.from_edges(61, np.array(edges))
    return g, _free(g), 64, 256


def _case_empty_runs():
    # single edges between runs of 1 to 120 empty rows, and a hub at the end:
    # an edge slot's next row lies past a run of empty rows
    rng = np.random.default_rng(5)
    rows = np.cumsum(rng.integers(1, 121, 40))
    hub = int(rows[-1]) + 1
    edges = [[int(r), hub] for r in rows] + [[hub, v] for v in range(hub + 1, hub + 30)]
    g = CSRGraph.from_edges(hub + 30, np.array(edges))
    return g, _free(g), bucket_size(g.n), bucket_size(int(g.indices.size))


def _case_n_eq_n_pad():
    g = grid_mesh_graph(8)  # n = 64
    return g, _free(g), 64, 512


def _case_e_eq_e_pad():
    g = rmat_graph(128, 4, seed=1)
    return g, _free(g), 128, int(g.indices.size)


def _case_odd_e_pad():
    # an odd edge bucket: the last slot has no pair to share a vector store
    g = rmat_graph(128, 4, seed=1)
    return g, _free(g), 128, int(g.indices.size) + 1


def _case_aux():
    # a batch model: 220 free rows and 8 pinned aux rows of degree up to b
    model, _, _ = _batch_model(rmat_graph(512, 8, seed=3))
    g = model.graph
    return g, model.pinned_block, bucket_size(g.n), bucket_size(int(g.indices.size))


CASES = {
    "empty": _case_empty,
    "isolated": _case_isolated,
    "truncated": _case_truncated,
    "empty_runs": _case_empty_runs,
    "n_eq_n_pad": _case_n_eq_n_pad,
    "e_eq_e_pad": _case_e_eq_e_pad,
    "odd_e_pad": _case_odd_e_pad,
    "aux": _case_aux,
}
WIDTHS = [None, 8, 32]


def _host_pack_on(g, pinned, n_pad, e_pad, w_pad, dev):
    """The V-cycle's pack as it was before `csr_pack`: the host pads and
    each buffer goes to `dev` as a pageable copy, in the same order."""
    return tuple(None if a is None else torch.from_numpy(a).to(dev)
                 for a in cp.host_pack(g, pinned, n_pad, e_pad, w_pad))


def _csr_tensors(g, pinned, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (g.indptr, g.indices, g.edge_w, g.node_w, pinned)]


def _assert_bit_equal(got, want):
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        a = a.cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("w_pad", WIDTHS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_host_pack(case, w_pad):
    g, pinned, n_pad, e_pad = CASES[case]()
    got = cp.csr_pack_plain(*_csr_tensors(g, pinned), n_pad, e_pad, w_pad)
    _assert_bit_equal(got, cp.host_pack(g, pinned, n_pad, e_pad, w_pad))
    # the wrapper takes the plain version for CPU tensors
    _assert_bit_equal(cp.csr_pack(*_csr_tensors(g, pinned), n_pad, e_pad, w_pad),
                      cp.host_pack(g, pinned, n_pad, e_pad, w_pad))


@pytest.mark.parametrize("case", sorted(CASES))
def test_compact_block_round_trip(case):
    """The CSR written into one uint8 block through `compact_views` reads
    back section by section, each 16-byte aligned, and packs as the host."""
    g, pinned, n_pad, e_pad = CASES[case]()
    n, e = g.n, int(g.indices.size)
    layout, total = cp.compact_layout(n, e)
    assert all(off % 16 == 0 for off, _ in layout)
    assert total == sum(-(-size // 16) * 16 for _, size in layout)
    assert total < 8 * e + 20 * n + 8 + 5 * 16
    block = torch.zeros(total, dtype=torch.uint8)
    arrays = (g.indptr, g.indices, g.edge_w, g.node_w, pinned)
    for view, a in zip(cp.compact_views(block, n, e), arrays):
        np.copyto(view.numpy(), a)
    views = cp.compact_views(block, n, e)
    for view, a in zip(views, arrays):
        assert view.numpy().tobytes() == np.ascontiguousarray(a).tobytes()
    _assert_bit_equal(cp.csr_pack(*views, n_pad, e_pad, 8),
                      cp.host_pack(g, pinned, n_pad, e_pad, 8))


def test_bound_bytes_counts_every_write():
    assert cp.bound_bytes(65536, 1 << 19, 32) == 24 * (1 << 19) + 16 * 65536 + 12 * 65536 * 32
    assert cp.bound_bytes(65536, 1 << 22, None) == 24 * (1 << 22) + 16 * 65536


def test_wrapper_refuses_bad_inputs():
    g, pinned, n_pad, e_pad = _case_aux()
    arrays = _csr_tensors(g, pinned)
    e = int(g.indices.size)
    with pytest.raises(TypeError, match="indices"):
        cp.csr_pack(arrays[0], arrays[1].long(), *arrays[2:], n_pad, e_pad)
    with pytest.raises(TypeError, match="edge_w"):
        cp.csr_pack(*arrays[:2], arrays[2].double(), *arrays[3:], n_pad, e_pad)
    with pytest.raises(ValueError, match="e_pad"):
        cp.csr_pack(*arrays, n_pad, e - 1)
    with pytest.raises(ValueError, match="n_pad"):
        cp.csr_pack(*arrays, g.n - 1, e_pad)
    for w_pad in (0, 6):
        with pytest.raises(ValueError, match="w_pad"):
            cp.csr_pack(*arrays, n_pad, e_pad, w_pad)
    with pytest.raises(ValueError, match="shape|n\\+1"):
        cp.csr_pack(arrays[0][:-1], *arrays[1:], n_pad, e_pad)
    meta = [a.to("meta") for a in arrays]
    with pytest.raises(ValueError, match="tensors on"):
        cp.csr_pack(*arrays[:4], meta[4], n_pad, e_pad)
    with pytest.raises(ValueError, match="cpu or cuda"):
        cp.csr_pack(*meta, n_pad, e_pad)


@pytest.mark.parametrize("w_pad", WIDTHS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_writes_every_slot_of_out(case, w_pad):
    """Into buffers allocated first (`pack_outputs`) and filled with junk,
    the plain version writes what the host pack writes."""
    g, pinned, n_pad, e_pad = CASES[case]()
    out = cp.pack_outputs(n_pad, e_pad, w_pad, "cpu")
    for t in out:
        if t is not None:
            t.fill_(7)
    got = cp.csr_pack(*_csr_tensors(g, pinned), n_pad, e_pad, w_pad, out=out)
    assert all(a is b for a, b in zip(got, out))
    _assert_bit_equal(got, cp.host_pack(g, pinned, n_pad, e_pad, w_pad))


def test_wrapper_refuses_a_wrong_out():
    g, pinned, n_pad, e_pad = _case_aux()
    arrays = _csr_tensors(g, pinned)
    good = cp.pack_outputs(n_pad, e_pad, 8, "cpu")
    for out in (cp.pack_outputs(n_pad, e_pad, None, "cpu"),   # no tiles where 8 are asked
                cp.pack_outputs(n_pad, 2 * e_pad, 8, "cpu"),  # another edge bucket
                (good[0].int(), *good[1:]),                   # another dtype
                good[:5]):
        with pytest.raises(ValueError, match="out"):
            cp.csr_pack(*arrays, n_pad, e_pad, 8, out=out)


def test_cpu_vcycle_packs_on_the_host():
    """On the CPU the V-cycle packs with the plain version from the same
    compact block: no kernel, no `pack_kernel` count, and the block's bytes
    counted as uploaded."""
    model, p, loads = _batch_model(rmat_graph(512, 8, seed=3))
    before = cp.launches
    tracing.enable()
    try:
        multilevel_partition(model.graph, model.pinned_block, p, loads,
                             MultilevelConfig(engine="torch", device="cpu"))
    finally:
        tracing.disable()
        records = tracing.drain()
    assert cp.launches == before
    pack = [r for r in records if r.name == "vcycle.pack"]
    assert len(pack) == 1 and "pack_kernel" not in pack[0].counts
    g = model.graph
    assert pack[0].counts["h2d_bytes"] == cp.compact_layout(g.n, int(g.indices.size))[1]


def test_cpu_vcycle_pack_is_the_host_pack(monkeypatch):
    """The CPU V-cycle's buffers are the host pack's bit for bit, and its
    labels with the host pack in its place are the same."""
    model, p, loads = _batch_model(rmat_graph(512, 8, seed=3))
    packed, real = [], mlt._pack

    def recording(*args):
        out = real(*args)
        packed.append((args[:5], out))
        return out

    monkeypatch.setattr(mlt, "_pack", recording)
    cfg = MultilevelConfig(engine="torch", device="cpu")
    labels = multilevel_partition(model.graph, model.pinned_block, p, loads, cfg)
    (args, out), = packed
    _assert_bit_equal(out, cp.host_pack(*args))
    monkeypatch.setattr(mlt, "_pack", _host_pack_on)
    np.testing.assert_array_equal(
        multilevel_partition(model.graph, model.pinned_block, p, loads, cfg), labels)


# ---------------------------------------------------------------- on a card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def synthetic_csr(n: int, degrees: np.ndarray, seed: int) -> CSRGraph:
    """A CSR of `n` rows with the given degrees and random neighbours and
    integer weights (not symmetric: the pack does not read symmetry)."""
    rng = np.random.default_rng(seed)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(degrees, out=indptr[1:])
    e = int(indptr[-1])
    return CSRGraph(indptr, rng.integers(0, n, e).astype(np.int32),
                    rng.integers(1, 9, e).astype(np.float32),
                    rng.integers(1, 4, n).astype(np.float32))


def _full_width(kind: str):
    """The cells' level-0 shapes: 32,768 free rows and 32 aux rows; `rgg`:
    ~450k directed edges in 2^19 slots and 32-wide tiles; `rmat`: ~2.6M
    edges in 2^22 slots, hub rows of tens of thousands, no tiles."""
    rng = np.random.default_rng(7)
    n = 32800
    if kind == "rgg":
        deg = rng.poisson(12.0, n)
        deg[-32:] = rng.integers(1000, 3000, 32)
        return synthetic_csr(n, deg, 1), 65536, 1 << 19, 32
    deg = np.minimum((rng.pareto(1.1, n) * 25).astype(np.int64), n - 1)
    deg = (deg * (2_600_000 / deg.sum())).astype(np.int64)
    return synthetic_csr(n, deg, 2), 65536, 1 << 22, None


def _pinned_for(g):
    pinned = np.full(g.n, -1, dtype=np.int64)
    pinned[-32:] = np.arange(32)
    return pinned


@pytest.mark.cuda
@pytest.mark.parametrize("w_pad", WIDTHS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_card(case, w_pad, card):
    g, pinned, n_pad, e_pad = CASES[case]()
    arrays = _csr_tensors(g, pinned, card)
    before = cp.launches
    got = cp.csr_pack(*arrays, n_pad, e_pad, w_pad)
    torch.cuda.synchronize()
    assert cp.launches == before + 1
    _assert_bit_equal(got, cp.host_pack(g, pinned, n_pad, e_pad, w_pad))
    _assert_bit_equal(cp.csr_pack(*arrays, n_pad, e_pad, w_pad),  # a second launch
                      cp.host_pack(g, pinned, n_pad, e_pad, w_pad))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rgg", "rmat"])
def test_kernel_matches_plain_at_full_width(kind, card):
    g, n_pad, e_pad, w_pad = _full_width(kind)
    pinned = _pinned_for(g)
    arrays = _csr_tensors(g, pinned, card)
    got = cp.csr_pack(*arrays, n_pad, e_pad, w_pad)
    want = cp.csr_pack_plain(*arrays, n_pad, e_pad, w_pad)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
def test_wrapper_refuses_mixed_devices_on_card(card):
    g, pinned, n_pad, e_pad = _case_aux()
    arrays = _csr_tensors(g, pinned, card)
    with pytest.raises(ValueError, match="tensors on"):
        cp.csr_pack(*arrays[:4], arrays[4].cpu(), n_pad, e_pad)
    with pytest.raises(ValueError, match="e_pad"):
        cp.csr_pack(*arrays, n_pad, int(g.indices.size) - 1)


def _traced_vcycle(model, p, loads, device):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tracing.enable()
    try:
        labels = multilevel_partition(model.graph, model.pinned_block, p, loads,
                                      MultilevelConfig(engine="torch", device=device))
    finally:
        tracing.disable()
        records = tracing.drain()
    torch.cuda.synchronize()
    return labels, records, torch.cuda.max_memory_allocated()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ell", "sort"])  # level-0 tiles taken, not taken
@pytest.mark.parametrize("graph", ["rmat", "grid"])
def test_vcycle_card_pack_matches_host(graph, mode, card, monkeypatch):
    g = rmat_graph(512, 8, seed=3) if graph == "rmat" else grid_mesh_graph(24)
    model, p, loads = _batch_model(g)
    want = multilevel_partition(model.graph, model.pinned_block, p, loads,
                                MultilevelConfig(engine="sparse", device="cpu"))
    monkeypatch.setattr(mlt, "MODE_OVERRIDE", mode)
    before = cp.launches
    labels, records, peak = _traced_vcycle(model, p, loads, str(card))
    np.testing.assert_array_equal(labels, want)
    assert cp.launches == before + 1
    pack = [r for r in records if r.name == "vcycle.pack"]
    assert len(pack) == 1 and pack[0].counts["pack_kernel"] == 1
    mg = model.graph
    assert pack[0].counts["h2d_bytes"] == cp.compact_layout(mg.n, int(mg.indices.size))[1]

    # the host pack on the card: the same labels, a peak no lower
    monkeypatch.setattr(mlt, "_pack", _host_pack_on)
    host_labels, host_records, host_peak = _traced_vcycle(model, p, loads, str(card))
    np.testing.assert_array_equal(host_labels, want)
    assert not any("pack_kernel" in r.counts for r in host_records)
    assert peak <= host_peak


@pytest.mark.cuda
@pytest.mark.parametrize("w_pad", [16, None])  # level-0 tiles taken, not taken
def test_card_pack_from_threads_at_once(w_pad, card):
    """The buffers the V-cycle reads, from the compact upload and the
    kernel, are the host pack's bit for bit, also while threads pack at
    once on their own streams (as the shard pool's workers do): each call's
    pinned block comes from the caching host allocator and is reused only
    after its copy.  No launch count is lost."""
    import sys
    import threading

    g, pinned, n_pad, e_pad = _case_aux()
    want = cp.host_pack(g, pinned, n_pad, e_pad, w_pad)
    threads_n, iters = 12, 20
    before = cp.launches
    errors, done = [], []

    def work():
        try:
            stream = torch.cuda.Stream(card)
            with torch.cuda.stream(stream):
                for _ in range(iters):
                    got = mlt._pack(g, pinned, n_pad, e_pad, w_pad, card)
                    _assert_bit_equal(got, want)
            done.append(True)
        except Exception as exc:  # reported below: a thread's failure fails the test
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert len(done) == threads_n
    assert cp.launches == before + threads_n * iters
