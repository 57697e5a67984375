"""repro_torch's sequential driver and its host modules against repro's:
labels and StreamStats, BucketPQ extraction traces, scores, metrics and
the config carried across."""
import dataclasses
import threading

import numpy as np
import pytest

from repro.core import metrics as ref_metrics
from repro.core.buffcut import BuffCutConfig as RefBuffCutConfig
from repro.core.buffcut import _buffcut_partition as ref_buffcut
from repro.core.buffer import BucketPQ as RefBucketPQ
from repro.core.multilevel import MultilevelConfig as RefMultilevelConfig
from repro.core.rescore import weighted_degrees as ref_weighted_degrees
from repro.core.scores import SCORES as REF_SCORES
from repro_torch.convert import buffcut_config_from_dict, graph_from_numpy
from repro_torch.core import (
    BuffCutConfig,
    buffcut_partition,
    buffcut_partition_pipelined,
    buffcut_partition_vectorized,
    metrics,
)
from repro_torch.core.buffer import BucketPQ
from repro_torch.core.rescore import weighted_degrees
from repro_torch.core.scores import SCORES


def _port(g):
    return graph_from_numpy(g.indptr, g.indices, g.edge_w, g.node_w)


def _ref_cfg(score="haa"):
    # d_max=24 turns the R-MAT fixture's heaviest nodes into hubs
    return RefBuffCutConfig(k=4, buffer_size=128, batch_size=32, d_max=24, score=score,
                            ml=RefMultilevelConfig(engine="sparse"))


def _port_cfg(ref_cfg, engine):
    cfg = buffcut_config_from_dict(ref_cfg.to_dict())
    return dataclasses.replace(cfg, ml=dataclasses.replace(cfg.ml, engine=engine, device="cpu"))


def _assert_same_run(g, ref_cfg, engine):
    want_block, want = ref_buffcut(g, ref_cfg)
    block, got = buffcut_partition(_port(g), _port_cfg(ref_cfg, engine))
    np.testing.assert_array_equal(block, want_block)
    assert got.cut_weight == want.cut_weight
    assert got.balance == want.balance
    assert got.n_batches == want.n_batches
    assert got.n_hubs == want.n_hubs
    assert got.block_loads == want.block_loads


@pytest.mark.parametrize("engine", ["sparse", "torch"])
@pytest.mark.parametrize("fixture", ["small_rmat", "small_grid", "random_grid", "small_sbm"])
def test_driver_matches_reference(fixture, engine, request):
    _assert_same_run(request.getfixturevalue(fixture), _ref_cfg(), engine)


@pytest.mark.parametrize("score", sorted(REF_SCORES))
def test_driver_matches_reference_for_every_score(score, small_rmat):
    _assert_same_run(small_rmat, _ref_cfg(score), "torch")


@pytest.mark.parametrize("seed", range(4))
def test_bucket_pq_extraction_trace_matches_reference(seed):
    rng = np.random.default_rng(seed)
    a, b = BucketPQ(1.75, 100), RefBucketPQ(1.75, 100)
    score = {}
    trace_a, trace_b = [], []
    nxt = 0
    for _ in range(3000):
        op = rng.random()
        if op < 0.4 or not score:
            s = float(rng.random() * 1.0)
            score[nxt] = s
            a.insert(nxt, s)
            b.insert(nxt, s)
            nxt += 1
        elif op < 0.8:
            v = int(rng.choice(list(score)))
            score[v] = score[v] + float(rng.random() * 0.2) * (rng.random() < 0.8)
            a.increase_key(v, score[v])
            b.increase_key(v, score[v])
        else:
            u, w = a.extract_max(), b.extract_max()
            trace_a.append(u)
            trace_b.append(w)
            del score[u]
        assert len(a) == len(b)
    while len(b):
        trace_a.append(a.extract_max())
        trace_b.append(b.extract_max())
    assert trace_a == trace_b


@pytest.mark.parametrize("engine", ["auto", "sparse", "ell", "jax"])
def test_config_round_trips_from_reference(engine):
    ref = RefBuffCutConfig(k=8, eps=0.05, buffer_size=512, batch_size=64, score="nss",
                           ml=RefMultilevelConfig(engine=engine, lp_iters=3))
    cfg = buffcut_config_from_dict(ref.to_dict())
    want = ref.to_dict()
    want["ml"] = dict(want["ml"], engine="torch" if engine == "jax" else engine,
                      device="cuda")
    assert cfg.to_dict() == want
    assert BuffCutConfig.from_dict(cfg.to_dict()) == cfg


def test_scores_match_reference():
    rng = np.random.default_rng(0)
    a, d, q, cm = (rng.random(50) * 40 for _ in range(4))
    d[:5] = 0.0
    for name, spec in SCORES.items():
        np.testing.assert_array_equal(spec(a, d, q, cm), REF_SCORES[name](a, d, q, cm))
        assert spec.s_max == REF_SCORES[name].s_max


def test_metrics_match_reference(small_sbm):
    g = _port(small_sbm)
    rng = np.random.default_rng(1)
    block = rng.integers(0, 5, g.n)
    assert metrics.edge_cut(g, block) == ref_metrics.edge_cut(small_sbm, block)
    assert metrics.cut_ratio(g, block) == ref_metrics.cut_ratio(small_sbm, block)
    assert metrics.balance(g, block, 5) == ref_metrics.balance(small_sbm, block, 5)
    assert metrics.l_max(384.0, 5, 0.03) == ref_metrics.l_max(384.0, 5, 0.03)
    np.testing.assert_array_equal(metrics.block_loads(g, block, 5),
                                  ref_metrics.block_loads(small_sbm, block, 5))
    bnodes = np.arange(100, 140)
    degs = np.diff(g.indptr)[bnodes]
    pos = g.slice_indices(bnodes)
    nbr, w = g.indices[pos].astype(np.int64), g.edge_w[pos]
    args = (bnodes, block[bnodes], degs, nbr, w, block)
    assert metrics.streaming_cut_increment(*args) == ref_metrics.streaming_cut_increment(*args)
    assert (metrics.internal_edge_ratio_adj(bnodes, nbr, w, g.n)
            == ref_metrics.internal_edge_ratio_adj(bnodes, nbr, w, g.n))


def test_weighted_degrees_match_reference(small_rmat):
    got = weighted_degrees(_port(small_rmat))
    assert got.tobytes() == ref_weighted_degrees(small_rmat).tobytes()


def test_unported_driver_options_raise(small_grid):
    cfg = _port_cfg(_ref_cfg(), "sparse")
    for driver in (buffcut_partition, buffcut_partition_pipelined,
                   buffcut_partition_vectorized):
        for kw in ({"ckpt": object()}, {"resume": {}}):
            with pytest.raises(NotImplementedError):
                driver(_port(small_grid), cfg, **kw)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetch_batches_matches_reference(depth, small_rmat):
    """The sequential driver reading ahead `depth` δ-batches on a thread:
    labels and stats equal the reference's at the same depth, and no pump
    thread outlives the run."""
    ref_cfg = _ref_cfg()
    want_block, want = ref_buffcut(small_rmat, ref_cfg, prefetch_batches=depth)
    block, got = buffcut_partition(_port(small_rmat), _port_cfg(ref_cfg, "sparse"),
                                   prefetch_batches=depth)
    np.testing.assert_array_equal(block, want_block)
    assert (got.cut_weight, got.balance, got.n_batches, got.n_hubs, got.block_loads) == (
        want.cut_weight, want.balance, want.n_batches, want.n_hubs, want.block_loads)
    assert got.stream_bytes_read == want.stream_bytes_read == 0
    assert got.io_retries == want.io_retries == 0
    assert not [t for t in threading.enumerate() if t.name == "prefetch-pump"]


def test_driver_on_missing_card_raises_before_any_record(small_grid):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card error path cannot be shown")
    cfg = _port_cfg(_ref_cfg(), "torch")
    cfg = dataclasses.replace(cfg, ml=dataclasses.replace(cfg.ml, device="cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        buffcut_partition(_port(small_grid), cfg)
