"""Pipelined BuffCut (paper §3.5 parallelization).

The paper overlaps three stages with threads and queues:
  T1 reader -> T2 priority-queue handler -> T3 partition worker.

T1 is the block prefetcher (core/prefetch.py): a background thread
produces block *i+1* of the stream while T2 scores block *i*, handing
records over in δ-batch-sized blocks (`PipelineConfig.prefetch_batches`
deep), so queue traffic is per block, not per record.  With
``prefetch_batches=0`` the same block iterator runs inline.

T2 is the **fused** per-record loop: score → buffer-insert → evict run in
plain Python on scalar counters (`RescoreState.*_scalar`,
`ScoreSpec.scalar_fn`) instead of a numpy dispatch per record, with state
bit-identical to the batched bumps (rescore.py, "scalar twins").

T3 receives self-contained payloads (a batch's retained adjacency, or one
hub record) and runs the batch V-cycle — on `cfg.ml.device` for the
device engines — or the hub's Fennel decision.  Nodes count as assigned
the moment their task is enqueued (paper: "as soon as their task is
enqueued"), and tasks commit in enqueue order under one lock, so
`block`/`loads` at every commit equal the sequential driver's and the
labels are bit-identical to `buffcut_partition`'s for every queue and
prefetch depth (for every score but CMS, whose per-block counts only the
sequential driver keeps, as in the reference).

On a card, T3 launches on the caller's device and current stream: both
are captured on the calling thread before T3 starts (torch keeps the
current device and stream per thread), and the kernel libraries are built
there first (`preflight`), never inside T3.  There is no host fallback: an
error in T3 is re-raised on the calling thread and fails the run.

Shutdown: every queue put/get is bounded and watches a shared stop event,
T3's exception is captured and re-raised on the calling thread, and a
``finally`` poison-pills and joins T3 and the prefetch pump on every exit
path.  `quiesce` waits until every enqueued task has committed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time

import numpy as np
import torch

from repro_torch.core.batch_model import build_batch_model_from_adj
from repro_torch.core.buffcut import BuffCutConfig, StreamStats
from repro_torch.core.buffer import BucketPQ
from repro_torch.core.fennel import FennelParams, fennel_choose
from repro_torch.core.metrics import internal_edge_ratio_adj, streaming_cut_increment
from repro_torch.core.multilevel import multilevel_partition
from repro_torch.core.prefetch import PrefetchStream, maybe_prefetch
from repro_torch.core.rescore import RescoreState
from repro_torch.device import preflight
from repro_torch.graphs.csr import CSRGraph
from repro_torch.graphs.stream import NodeStreamBase, as_node_stream

# granularity of the stop-event checks around blocking queue operations
_POLL_S = 0.05
_JOIN_TIMEOUT_S = 5.0


@dataclasses.dataclass
class PipelineConfig:
    """Knobs of the pipelined driver.

    `prefetch_batches` is the T1 read-ahead depth in δ-batches: 0 reads
    inline, 1 is classic double buffering, more deepens the window.  Like
    `queue_depth`, it changes throughput and staging residency, never
    labels.
    """

    queue_depth: int = 4        # T2 -> T3 task queue bound
    prefetch_batches: int = 2   # T1 read-ahead depth, in δ-batch blocks

    def __post_init__(self) -> None:
        if self.queue_depth < 1:
            raise ValueError(f"PipelineConfig.queue_depth must be >= 1, got {self.queue_depth}")
        if self.prefetch_batches < 0:
            raise ValueError(
                f"PipelineConfig.prefetch_batches must be >= 0, got {self.prefetch_batches}"
            )


def _payload_bytes(arrays) -> int:
    return int(sum(a.nbytes for a in arrays if isinstance(a, np.ndarray)) + 64)


def buffcut_partition_pipelined(
    g: CSRGraph | NodeStreamBase,
    cfg: BuffCutConfig,
    pipe: PipelineConfig | None = None,
    *,
    ckpt=None,
    resume: dict | None = None,
) -> tuple[np.ndarray, StreamStats]:
    """Partition a node stream into `cfg.k` blocks with the three-stage
    pipeline; returns (block, stats) equal to `buffcut_partition`'s.

    `stats.ml_time_s` is T3's time inside the V-cycle and `stats.t3_wait_s`
    the time T2 spent blocked on T3 (a full task queue, the final drain),
    so `runtime_s - t3_wait_s` is T2's own time.
    """
    if ckpt is not None or resume is not None:
        raise NotImplementedError("checkpoint/resume is not ported to repro_torch yet")
    pipe = pipe if pipe is not None else PipelineConfig()
    # the caller's device and current stream, for T3: torch keeps both per
    # thread, and the kernel libraries are built here, not inside T3
    launch_ctx: tuple = ()
    if cfg.ml.engine != "sparse":
        dev = preflight(cfg.ml.device)
        if dev.type == "cuda":
            caller_stream = torch.cuda.current_stream(dev)
            launch_ctx = (caller_stream.device, caller_stream)
    blk = max(1, cfg.batch_size)
    stream = maybe_prefetch(as_node_stream(g), pipe.prefetch_batches, blk)
    n = stream.n
    spec = cfg.score_spec()
    p = FennelParams(k=cfg.k, n_total=stream.n_total, m_total=stream.m_total,
                     eps=cfg.eps, gamma=cfg.gamma)
    st = RescoreState(n, spec, cfg.k)
    pq = BucketPQ(spec.s_max, cfg.disc_factor)
    block = np.full(n, -1, dtype=np.int64)
    loads = np.zeros(cfg.k, dtype=np.float64)
    lock = threading.Lock()  # commit lock: T3 holds it across a task
    task_q: queue.Queue = queue.Queue(maxsize=pipe.queue_depth)
    stats = StreamStats()
    batch: list[int] = []
    t0 = time.perf_counter()

    stop = threading.Event()
    worker_err: list[BaseException] = []
    done_cv = threading.Condition()
    counts = {"put": 0, "done": 0}  # tasks enqueued / tasks committed
    waited = [0.0]  # T2's time blocked on T3

    def check_worker() -> None:
        if worker_err:
            raise worker_err[0]

    def quiesce() -> None:
        """Wait until T3 has committed every enqueued task."""
        t_wait = time.perf_counter()
        with done_cv:
            while counts["done"] < counts["put"]:
                check_worker()
                done_cv.wait(timeout=_POLL_S)
        waited[0] += time.perf_counter() - t_wait
        check_worker()

    # bytes of the batch and hub payloads queued or in T3: released cache
    # entries live on in payloads until T3 is done with them.  T1's staged
    # blocks are inside stream.resident_bytes.
    inflight = {"task_bytes": 0}
    # inflight has its own lock: T2 must never wait on the commit lock
    # (which T3 holds across a whole V-cycle) to bump a byte counter.
    # Lock order is commit lock -> ilock only.
    ilock = threading.Lock()

    def note_peak(extra: int = 0) -> None:
        with ilock:
            resident = (st.adj.resident_bytes + inflight["task_bytes"]
                        + stream.resident_bytes + extra)
            if resident > stats.peak_resident_bytes:
                stats.peak_resident_bytes = resident

    def commit(kind: str, payload) -> None:
        if kind == "batch":
            bnodes, degs, nbr_c, w_c, node_w_b = payload
            model = build_batch_model_from_adj(n, bnodes, degs, nbr_c, w_c, node_w_b, block,
                                               cfg.k)
            note_peak(model.graph.indices.nbytes + model.graph.edge_w.nbytes)
            t_ml = time.perf_counter()
            labels = multilevel_partition(model.graph, model.pinned_block, p, loads, cfg.ml)
            stats.ml_time_s += time.perf_counter() - t_ml
            lab_b = labels[: bnodes.shape[0]]
            block[bnodes] = lab_b
            np.add.at(loads, lab_b, node_w_b.astype(np.float64))
            stats.cut_weight += streaming_cut_increment(bnodes, lab_b, degs, nbr_c, w_c,
                                                        block)
            stats.n_batches += 1
            if cfg.collect_stats:
                stats.ier_per_batch.append(internal_edge_ratio_adj(bnodes, nbr_c, w_c, n))
        else:  # one hub: the payload is its stream record
            v, nbrs, nbr_w, node_w = payload
            i = fennel_choose(nbrs, nbr_w, float(node_w), block, loads, p)
            block[v] = i
            loads[i] += np.float32(node_w)
            hv = np.array([v], dtype=np.int64)
            stats.cut_weight += streaming_cut_increment(
                hv, np.array([i], dtype=np.int64), np.array([nbrs.size], dtype=np.int64),
                nbrs.astype(np.int64), nbr_w.astype(np.float64), block)
            stats.n_hubs += 1

    def partition_worker() -> None:  # T3
        try:
            with contextlib.ExitStack() as launch_on:
                if launch_ctx:
                    launch_on.enter_context(torch.cuda.device(launch_ctx[0]))
                    launch_on.enter_context(torch.cuda.stream(launch_ctx[1]))
                while True:
                    try:
                        item = task_q.get(timeout=_POLL_S)
                    except queue.Empty:
                        if stop.is_set():
                            return
                        continue
                    if item is None:
                        return
                    kind, payload = item
                    with lock:
                        commit(kind, payload)
                    with ilock:
                        inflight["task_bytes"] -= _payload_bytes(payload)
                    with done_cv:
                        counts["done"] += 1
                        done_cv.notify_all()
        except BaseException as e:  # noqa: BLE001 — re-raised on the caller
            worker_err.append(e)
            stop.set()
            with done_cv:
                done_cv.notify_all()

    # daemon=True is a backstop only: the finally below always poison-pills
    # and joins
    worker = threading.Thread(target=partition_worker, name="buffcut-t3", daemon=True)
    worker.start()

    def put_task(item) -> None:
        t_wait = time.perf_counter()
        while True:
            check_worker()
            try:
                task_q.put(item, timeout=_POLL_S)
                if item is not None:  # the poison pill is not a task
                    counts["put"] += 1
                break
            except queue.Full:
                continue
        waited[0] += time.perf_counter() - t_wait

    def flush_batch() -> None:
        if batch:
            bnodes = np.asarray(batch, dtype=np.int64)
            nbr_c, w_c, degs = st.adj.slice(bnodes)
            node_w_b = st.adj.node_weights(bnodes)
            st.release(bnodes)  # the payload is self-contained; the cache shrinks now
            payload = (bnodes, degs, nbr_c, w_c, node_w_b)
            with ilock:
                inflight["task_bytes"] += _payload_bytes(payload)
            put_task(("batch", payload))
            batch.clear()

    def blocks():
        """Record blocks: T1's thread when configured, inline chunking
        otherwise — the same record sequence either way."""
        if isinstance(stream, PrefetchStream):
            for recs, _tokens in stream.blocks():
                yield recs
            return
        recs: list = []
        for rec in stream:
            recs.append(rec)
            if len(recs) == blk:
                yield recs
                recs = []
        if recs:
            yield recs

    # ---- T2: the fused scalar loop, Python-float math on the shared
    # RescoreState counters, bit-identical to the batched bumps
    fscore = spec.scalar_fn()
    nss = spec.needs_buffered_count
    member = st.member
    adj = st.adj
    inc = pq.increase_key
    insert = pq.insert
    extract = pq.extract_max
    d_max = cfg.d_max
    buffer_size = cfg.buffer_size
    batch_size = cfg.batch_size

    def evict() -> None:
        u = extract()
        member[u] = False
        batch.append(u)
        st.bump_assigned_scalar(u, True, fscore, inc)
        if len(batch) == batch_size:
            flush_batch()

    try:
        for recs in blocks():
            check_worker()
            for v, nbrs, nbr_w, node_w in recs:
                st.observe_scalar(v, nbrs, nbr_w, node_w)
                if nbrs.size > d_max:
                    payload = (v, nbrs, nbr_w, node_w)
                    with ilock:
                        inflight["task_bytes"] += _payload_bytes(payload)
                    put_task(("hub", payload))
                    st.bump_assigned_scalar(v, False, fscore, inc)  # enqueued == assigned
                    adj.drop_one(v)
                else:
                    if nss:
                        st.bump_buffered_scalar(v, fscore, inc)
                    insert(v, st.score_scalar(v, fscore))
                    member[v] = True
                while len(pq) >= buffer_size and len(batch) < batch_size:
                    evict()
            note_peak()
        while len(pq) > 0:
            evict()
        flush_batch()
        quiesce()
        put_task(None)
        worker.join(timeout=_JOIN_TIMEOUT_S)
        check_worker()
    finally:
        # every exit path — normal, stream error, T3 failure — tears the
        # pipeline down: wake anything blocked, then join with a timeout
        stop.set()
        worker.join(timeout=_JOIN_TIMEOUT_S)
        if isinstance(stream, PrefetchStream):
            stream.close()
    with lock:
        stats.balance = float(loads.max() / (p.n_total / cfg.k)) if p.n_total > 0 else 1.0
    stats.block_loads = loads.tolist()
    stats.stream_bytes_read = stream.bytes_read
    stats.io_retries = int(getattr(stream, "io_retries", 0))
    stats.t3_wait_s = waited[0]
    stats.runtime_s = time.perf_counter() - t0
    return block, stats
