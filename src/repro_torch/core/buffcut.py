"""BuffCut sequential driver — paper Algorithm 1.

Streamed nodes either bypass the buffer (hubs, d > D_max → immediate
Fennel) or enter the bounded priority buffer Q.  When |Q| = Q_max the
top-priority node is evicted into the active batch; admissions bump the
scores of buffered neighbors (IncreaseKey), which is what recovers locality
from adversarial orders.  Full batches are partitioned jointly on the batch
model graph by the multilevel scheme — on `cfg.ml.device` for the `torch`,
`ell` and `auto` engines — and their assignments commit.

The driver consumes only the node-stream protocol (graphs/stream.py).
Adjacency is retained solely for nodes that are buffered, batched, or
mid-hub-assignment and released at commit, so peak resident memory is
buffer + batch, measured in `StreamStats.peak_resident_bytes`.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.batch_model import build_batch_model_from_adj
from repro_torch.core.buffer import BucketPQ
from repro_torch.core.fennel import FennelParams, fennel_choose
from repro_torch.core.metrics import internal_edge_ratio_adj, streaming_cut_increment
from repro_torch.core.multilevel import MultilevelConfig, multilevel_partition
from repro_torch.core.prefetch import PrefetchStream, maybe_prefetch
from repro_torch.core.rescore import RescoreState
from repro_torch.core.scores import SCORES, ScoreSpec, get_score
from repro_torch.device import preflight
from repro_torch.graphs.csr import CSRGraph
from repro_torch.graphs.stream import NodeStreamBase, as_node_stream


@dataclasses.dataclass
class BuffCutConfig:
    k: int
    eps: float = 0.03
    buffer_size: int = 4096          # Q_max
    batch_size: int = 1024           # delta
    d_max: float = 10000.0           # hub threshold (paper default)
    score: str | ScoreSpec = "haa"
    disc_factor: int = 1000          # paper default
    gamma: float = 1.5
    ml: MultilevelConfig = dataclasses.field(default_factory=MultilevelConfig)
    collect_stats: bool = False

    def __post_init__(self) -> None:
        if self.k < 2:
            raise ValueError(
                f"BuffCutConfig.k must be >= 2 (got {self.k}): partitioning "
                "into fewer than 2 blocks is a no-op"
            )
        if self.eps <= 0:
            raise ValueError(
                f"BuffCutConfig.eps must be > 0 (got {self.eps}): the balance "
                "cap is (1+eps)*c(V)/k (paper default: 0.03)"
            )
        if self.buffer_size < 1:
            raise ValueError(
                f"BuffCutConfig.buffer_size (Q_max) must be >= 1, got {self.buffer_size}"
            )
        if self.batch_size < 1:
            raise ValueError(
                f"BuffCutConfig.batch_size (delta) must be >= 1, got {self.batch_size}"
            )
        if self.batch_size > self.buffer_size and self.buffer_size != 1:
            # buffer_size == 1 is the paper's Q=1 degeneracy (contiguous
            # batches == HeiStream) and pairs with any delta
            raise ValueError(
                f"BuffCutConfig requires batch_size <= buffer_size (got "
                f"batch_size={self.batch_size} > buffer_size={self.buffer_size})"
            )
        if self.d_max <= 0:
            raise ValueError(
                f"BuffCutConfig.d_max (hub threshold) must be > 0, got {self.d_max}"
            )
        if self.disc_factor < 1:
            raise ValueError(
                f"BuffCutConfig.disc_factor must be >= 1, got {self.disc_factor}"
            )
        if isinstance(self.score, str) and self.score.lower() not in SCORES:
            raise ValueError(
                f"unknown score {self.score!r}: known scores are "
                f"{sorted(SCORES)} (or pass a ScoreSpec instance)"
            )

    def score_spec(self) -> ScoreSpec:
        if isinstance(self.score, ScoreSpec):
            return dataclasses.replace(self.score, d_max=float(self.d_max))
        return get_score(self.score, d_max=float(self.d_max))

    def to_dict(self) -> dict:
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, ScoreSpec):
                v = dataclasses.asdict(v)
            elif isinstance(v, MultilevelConfig):
                v = v.to_dict()
            out[f.name] = v
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "BuffCutConfig":
        d = dict(d)
        if isinstance(d.get("score"), dict):
            d["score"] = ScoreSpec(**d["score"])
        if isinstance(d.get("ml"), dict):
            d["ml"] = MultilevelConfig.from_dict(d["ml"])
        return cls(**d)


@dataclasses.dataclass
class StreamStats:
    runtime_s: float = 0.0
    ml_time_s: float = 0.0            # time inside multilevel_partition
    n_batches: int = 0
    n_hubs: int = 0
    ier_per_batch: list = dataclasses.field(default_factory=list)
    peak_mem_items: int = 0           # buffer + batch + model working set
    evictions: list = dataclasses.field(default_factory=list)
    cut_weight: float = 0.0           # exact edge cut, accumulated at commits
    balance: float = 0.0              # max load / (c(V)/k) at stream end
    peak_resident_bytes: int = 0      # retained adjacency + read-ahead, peak
    stream_bytes_read: int = 0        # bytes pulled from the stream backend
    block_loads: list = dataclasses.field(default_factory=list)
    io_retries: int = 0               # transient stream-IO errors absorbed
    t3_wait_s: float = 0.0            # pipelined driver: T2's time blocked on T3


def _apply(pq: BucketPQ, touched: np.ndarray, scores: np.ndarray) -> None:
    """Forward batched rescores to the PQ in first-occurrence order."""
    for w_, s in zip(touched.tolist(), scores.tolist()):
        pq.increase_key(w_, s)


def buffcut_partition(
    g: CSRGraph | NodeStreamBase,
    cfg: BuffCutConfig,
    *,
    prefetch_batches: int = 0,
    ckpt=None,
    resume: dict | None = None,
) -> tuple[np.ndarray, StreamStats]:
    """Partition a node stream into `cfg.k` blocks; returns (block, stats).

    Before the first record the device is checked and, for a card, the
    kernel libraries are built and loaded (`repro_torch.device.preflight`),
    so a missing card or a kernel that does not build fails the run before
    any work.  Unlike the reference, a batch has no host fallback: any error
    of a device engine (a kernel that does not launch, a CUDA fault
    mid-batch) propagates.

    `prefetch_batches > 0` reads the stream ahead on a background thread
    (`core/prefetch.py`) in δ-batch blocks; record order, and so every
    label, is unchanged.
    """
    if ckpt is not None or resume is not None:
        raise NotImplementedError("checkpoint/resume is not ported to repro_torch yet")
    if cfg.ml.engine != "sparse":
        preflight(cfg.ml.device)
    stream = maybe_prefetch(as_node_stream(g), prefetch_batches, cfg.batch_size)
    try:
        return _run(stream, cfg)
    finally:
        if isinstance(stream, PrefetchStream):
            stream.close()  # joins the pump on every exit path


def _run(stream: NodeStreamBase, cfg: BuffCutConfig) -> tuple[np.ndarray, StreamStats]:
    n = stream.n
    spec = cfg.score_spec()
    p = FennelParams(
        k=cfg.k,
        n_total=stream.n_total,
        m_total=stream.m_total,
        eps=cfg.eps,
        gamma=cfg.gamma,
    )
    st = RescoreState(n, spec, cfg.k)
    pq = BucketPQ(spec.s_max, cfg.disc_factor)
    block = np.full(n, -1, dtype=np.int64)
    loads = np.zeros(cfg.k, dtype=np.float64)
    batch: list[int] = []
    stats = StreamStats()
    t0 = time.perf_counter()

    def note_peak(extra: int = 0) -> None:
        resident = st.adj.resident_bytes + stream.resident_bytes + extra
        if resident > stats.peak_resident_bytes:
            stats.peak_resident_bytes = resident

    def commit_batch() -> None:
        if not batch:
            return
        bnodes = np.asarray(batch, dtype=np.int64)
        nbr_c, w_c, degs = st.adj.slice(bnodes)
        node_w_b = st.adj.node_weights(bnodes)
        model = build_batch_model_from_adj(
            n, bnodes, degs, nbr_c, w_c, node_w_b, block, cfg.k
        )
        t_ml = time.perf_counter()
        labels = multilevel_partition(model.graph, model.pinned_block, p, loads, cfg.ml)
        stats.ml_time_s += time.perf_counter() - t_ml
        lab_b = labels[: bnodes.shape[0]]
        block[bnodes] = lab_b
        np.add.at(loads, lab_b, node_w_b.astype(np.float64))
        stats.cut_weight += streaming_cut_increment(bnodes, lab_b, degs, nbr_c, w_c, block)
        note_peak(model.graph.indices.nbytes + model.graph.edge_w.nbytes)
        if cfg.collect_stats:
            stats.ier_per_batch.append(internal_edge_ratio_adj(bnodes, nbr_c, w_c, n))
            stats.peak_mem_items = max(
                stats.peak_mem_items, len(pq) + len(batch) + model.graph.indices.shape[0]
            )
        stats.n_batches += 1
        # CMS: buffered neighbors now see concrete blocks
        if st.blk_w is not None:
            for u, b_ in zip(bnodes, lab_b):
                _apply(pq, *st.bump_block_counts(int(u), int(b_)))
        st.release(bnodes)
        batch.clear()

    def evict_one() -> None:
        u = pq.extract_max()
        st.member[u] = False
        st.drop_block_counts(u)
        batch.append(u)
        if cfg.collect_stats:
            stats.evictions.append(u)
        _apply(pq, *st.bump_assigned(np.array([u], dtype=np.int64), True))
        if len(batch) == cfg.batch_size:
            commit_batch()

    one = np.empty(1, dtype=np.int64)
    for v, nbrs, nbr_w, node_w in stream:
        st.observe(v, nbrs, nbr_w, node_w)
        note_peak()
        if nbrs.size > cfg.d_max:  # hub bypass: assign immediately via Fennel
            i = fennel_choose(nbrs, nbr_w, node_w, block, loads, p)
            block[v] = i
            loads[i] += node_w
            stats.n_hubs += 1
            one[0] = v
            hnbr, hw, hdeg = st.adj.slice(one)
            stats.cut_weight += streaming_cut_increment(
                one, np.array([i], dtype=np.int64), hdeg, hnbr, hw, block
            )
            _apply(pq, *st.bump_assigned(one, False))
            _apply(pq, *st.bump_block_counts(v, i))
            st.release(one)
        else:
            _apply(pq, *st.bump_buffered(np.array([v], dtype=np.int64)))
            pq.insert(v, st.score(v))
            st.member[v] = True
            if cfg.collect_stats:
                stats.peak_mem_items = max(stats.peak_mem_items, len(pq) + len(batch))
        while len(pq) >= cfg.buffer_size and len(batch) < cfg.batch_size:
            evict_one()

    # flush (paper Alg. 1 tail)
    while len(pq) > 0:
        evict_one()
    commit_batch()
    stats.balance = float(loads.max() / (p.n_total / cfg.k)) if p.n_total > 0 else 1.0
    stats.block_loads = loads.tolist()
    stats.stream_bytes_read = stream.bytes_read
    stats.io_retries = int(getattr(stream, "io_retries", 0))
    stats.runtime_s = time.perf_counter() - t0
    return block, stats
