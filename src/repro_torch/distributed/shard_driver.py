"""Sharded multi-worker BuffCut: W contiguous id-range shards, one driver
per worker, loads kept approximately consistent by a periodic sync barrier.

The stream is split into W contiguous id-range shards —
`graphs.stream_io.shard_ranges` (the span arithmetic of `permute_to_disk`'s
destination buckets) plus one bounded boundary scan (`shard_boundary_pass`)
for disk sources — and each worker runs the unmodified sequential driver
(`core.buffcut._buffcut_partition`) over a `StreamShard` view with its own
`AdjacencyCache`, buffer and file handle.  Shard streams report *global*
aggregates, so every worker's `FennelParams` (and so its balance cap and
gamma) are bit-identical to the single-worker run's.

Load sync: every `load_sync_every` committed batches a worker publishes the
delta of its own per-block loads to the lock-protected `SharedLoads`
accumulator and blocks until every other worker has published the same
round (or finished), then folds the others' loads into the live array
through the driver's `on_batch` hook.  The barrier is publish-then-wait, so
it cannot deadlock, and reads are *round-indexed*: worker w at round r
always sees the other workers' loads at *their* round r (immutable
history), never "whatever they have right now" — which makes the sharded
labels deterministic across runs whatever the thread scheduling.
Staleness is bounded by `load_sync_every` batches per worker.

Workers never see other shards' labels (those stay -1 in their private
label arrays), so each worker's streamed cut counts exactly the intra-shard
edges.  The merge phase recovers the *exact* global accounting with one
more bounded replay, parallelized across the same workers: each re-reads
only its own shard against the merged labels, accumulating exact per-block
float64 loads (id order within the shard, worker-index order across shards)
and the cross-shard cut (each cross edge charged once, at its higher-id
endpoint).  In-memory graph sources skip the replay for a vectorized
whole-graph pass.  A caller then seeds `restream_refine` with the merged
labels and the exact cut and loads — the reconciliation pass.

Every worker's V-cycles run on the card for the device engines:
`shard_partition` checks the device and builds the kernel libraries once,
in the calling thread (`repro_torch.device.preflight`), and each worker
thread launches on the caller's device and current CUDA stream, captured at
the call (the pipelined driver's idiom, core/pipeline.py).  A device error
in any worker fails the run; there is no host fallback.

Thread workers take turns between barriers (`_Turn`), so the interpreter
lock does not change hands inside their host loops.

Backends: ``thread`` (default) is the determinism and conformance anchor;
``process`` forks one child per shard (POSIX only) for multi-core scaling
of the host engine — the children speak a small pipe protocol to
per-worker proxy threads in the parent, which run the *same* `SharedLoads`
barrier, so both backends give identical labels.  Neither a CUDA context
nor torch's CPU thread pool survives `fork`, so the process backend
refuses, before it forks, any configuration whose V-cycle runs torch ops
(every one but the host `sparse` engine, and `auto` on the CPU).

`ShardPool.run` waits for its workers with no deadline: a worker that
takes longer than `_JOIN_TIMEOUT_S` is still working, not stuck.  The join
limit bounds only the shutdown path, after an abort or `close()`.

W=1 short-circuits to the sequential driver — bit-identical by
construction, zero extra passes.
"""
from __future__ import annotations

import contextlib
import multiprocessing
import threading
import time
import traceback
import warnings

import numpy as np

from repro_torch.core.buffcut import BuffCutConfig, StreamStats, _buffcut_partition
from repro_torch.device import preflight
from repro_torch.graphs.csr import CSRGraph
from repro_torch.graphs.stream import (
    NodeStream,
    NodeStreamBase,
    StreamShard,
    as_node_stream,
)
from repro_torch.graphs.stream_io import DiskNodeStream, shard_boundary_pass, shard_ranges

_POLL_S = 0.05
_JOIN_TIMEOUT_S = 5.0


class ShardWorkerError(RuntimeError):
    """A shard worker failed (or the run was aborted); the pool joins every
    thread/process before this propagates — errors cross the worker
    boundary, workers do not leak."""


class _Aborted(ShardWorkerError):
    """Internal: raised in workers observing an abort someone else caused."""


# ------------------------------------------------------------- SharedLoads


class SharedLoads:
    """Lock-protected per-block load accumulator with round-indexed history.

    Workers `publish(w, delta)` their own-load deltas; each worker's
    cumulative loads are folded left-to-right in publish order and stored
    per round as an immutable snapshot.  `others_at(w, rnd)` blocks until
    every other worker has published round `rnd` or finished, then returns
    the float64 sum of their round-`rnd` (or final) loads accumulated in
    worker-index order — both summation orders are pinned, so no
    interleaving of publishes can change a single bit of the result.
    `abort` wakes every waiter with an error instead of a value, which is
    how worker failure propagates without deadlocking the barrier.
    """

    def __init__(self, workers: int, k: int):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.workers = int(workers)
        self.k = int(k)
        self._cv = threading.Condition(threading.Lock())
        self._hist: list[list[np.ndarray]] = [[] for _ in range(workers)]
        self._final: list[np.ndarray | None] = [None] * workers
        self._abort_msg: str | None = None

    def _check(self, w: int, delta) -> np.ndarray:
        if not (0 <= w < self.workers):
            raise ValueError(f"worker index {w} outside [0, {self.workers})")
        d = np.asarray(delta, dtype=np.float64)
        if d.shape != (self.k,):
            raise ValueError(f"delta shape {d.shape} != ({self.k},)")
        return d

    def publish(self, w: int, delta) -> None:
        d = self._check(w, delta)
        with self._cv:
            if self._final[w] is not None:
                raise ValueError(f"worker {w} already finished")
            prev = self._hist[w][-1] if self._hist[w] else np.zeros(self.k)
            cum = prev + d
            cum.setflags(write=False)  # round snapshots are immutable
            self._hist[w].append(cum)
            self._cv.notify_all()

    def finish(self, w: int, delta=None) -> None:
        d = self._check(w, delta if delta is not None else np.zeros(self.k))
        with self._cv:
            if self._final[w] is not None:
                raise ValueError(f"worker {w} already finished")
            prev = self._hist[w][-1] if self._hist[w] else np.zeros(self.k)
            fin = prev + d
            fin.setflags(write=False)
            self._final[w] = fin
            self._cv.notify_all()

    def abort(self, msg: str) -> None:
        with self._cv:
            if self._abort_msg is None:
                self._abort_msg = msg
            self._cv.notify_all()

    @property
    def aborted(self) -> "str | None":
        with self._cv:
            return self._abort_msg

    def rounds(self, w: int) -> int:
        with self._cv:
            return len(self._hist[w])

    def others_at(self, w: int, rnd: int) -> np.ndarray:
        """Blocking barrier read: the summed loads of every *other* worker
        at round `rnd` (its final loads if it finished with fewer rounds)."""
        with self._cv:
            while True:
                if self._abort_msg is not None:
                    raise _Aborted(self._abort_msg)
                if all(
                    len(self._hist[o]) > rnd or self._final[o] is not None
                    for o in range(self.workers) if o != w
                ):
                    break
                self._cv.wait(_POLL_S)
            out = np.zeros(self.k, dtype=np.float64)
            for o in range(self.workers):
                if o == w:
                    continue
                h = self._hist[o]
                out = out + (h[rnd] if len(h) > rnd else self._final[o])
            return out

    def total(self) -> np.ndarray:
        """Global per-block loads after every worker finished: the final
        cumulative vectors summed in worker-index order."""
        with self._cv:
            missing = [o for o in range(self.workers) if self._final[o] is None]
            if missing:
                raise ValueError(f"workers {missing} have not finished")
            out = np.zeros(self.k, dtype=np.float64)
            for o in range(self.workers):
                out = out + self._final[o]
            return out


class _LoadSync:
    """`on_batch` hook: every `every` commits, publish the own-load delta
    through `exchange(delta, round)` and fold the returned others-loads into
    the driver's live array.  Own loads are recovered as ``loads - others``
    — a float64 approximation (fine for in-flight balancing; the merge
    replay recomputes exact loads), but a *deterministic* one: the same
    float ops run in the same order every run."""

    def __init__(self, exchange, every: int, k: int):
        self.exchange = exchange
        self.every = max(1, int(every))
        self.others = np.zeros(k, dtype=np.float64)
        self.own_pub = np.zeros(k, dtype=np.float64)
        self.calls = 0
        self.rounds = 0

    def __call__(self, n_batches: int, loads: np.ndarray) -> None:
        self.calls += 1
        if self.calls % self.every:
            return
        own = loads - self.others
        others = self.exchange(own - self.own_pub, self.rounds)
        self.rounds += 1
        self.own_pub = own
        self.others = np.asarray(others, dtype=np.float64)
        loads[:] = own + self.others

    def final_delta(self, final_loads) -> np.ndarray:
        own = np.asarray(final_loads, dtype=np.float64) - self.others
        return own - self.own_pub


class _Gate:
    """Abortable count-down latch between the drive and merge phases: every
    worker arrives with its labels published, waiters proceed when all have
    (the merge replay needs the complete merged label array)."""

    def __init__(self, parties: int, shared: SharedLoads):
        self.parties = parties
        self.shared = shared
        self._cv = threading.Condition(threading.Lock())
        self._arrived = 0

    def arrive_and_wait(self) -> None:
        with self._cv:
            self._arrived += 1
            self._cv.notify_all()
            while self._arrived < self.parties:
                if self.shared.aborted is not None:
                    raise _Aborted(self.shared.aborted)
                self._cv.wait(_POLL_S)
        if self.shared.aborted is not None:
            raise _Aborted(self.shared.aborted)


class _Turn:
    """A thread worker's turn to run host code; one turn at a time.

    Under the interpreter lock the workers' host loops cannot run in
    parallel anyway, and interleaved they hand the lock over whenever one
    enters numpy code that releases it, each handover a thread wake-up
    (four interleaved workers took 2.95x the sequential driver's time on
    the card's host).  So a worker holds its turn from the start of its
    drive to its next barrier wait, and again for its merge leg.  Labels
    do not depend on the order of turns: the barrier is round-indexed."""

    def __init__(self, lock: threading.Lock, shared: SharedLoads):
        self._lock = lock
        self._shared = shared
        self._held = False

    def take(self) -> None:
        while not self._lock.acquire(timeout=_POLL_S):
            if self._shared.aborted is not None:
                raise _Aborted(self._shared.aborted)
        self._held = True

    def give(self) -> None:
        if self._held:
            self._held = False
            self._lock.release()


# ------------------------------------------------------------- shard split


def _make_factories(stream: NodeStreamBase, ranges) -> "tuple[list, int]":
    """One zero-arg `StreamShard` factory per range, plus the split-scan
    bytes.  Graph-backed parents position by index (free); disk parents get
    resume tokens from one bounded boundary scan and private file handles
    per worker (opener/retry inherited, so fault injection and `RetryPolicy`
    flow through to every shard reader)."""
    if isinstance(stream, NodeStream):
        g = stream._g

        def graph_factory(lo: int, hi: int):
            def make() -> StreamShard:
                parent = NodeStream(g)
                return StreamShard(
                    parent, lambda: parent.iter_from({"index": lo}), lo, hi
                )
            return make

        return [graph_factory(lo, hi) for lo, hi in ranges], 0
    if isinstance(stream, DiskNodeStream):
        path, chunk = stream.path, stream.io_chunk_bytes
        opener, retry = stream.opener, stream.retry
        bytes0 = stream.bytes_read
        tokens, _ = shard_boundary_pass(stream, ranges)

        def disk_factory(token: dict, lo: int, hi: int):
            def make() -> StreamShard:
                parent = DiskNodeStream(path, chunk, opener=opener, retry=retry)
                return StreamShard(
                    parent, lambda: parent.iter_from(dict(token)), lo, hi
                )
            return make

        return (
            [disk_factory(t, lo, hi) for t, (lo, hi) in zip(tokens, ranges)],
            stream.bytes_read - bytes0,
        )
    raise ValueError(
        f"{type(stream).__name__} is not shardable: the sharded driver needs "
        "a replayable source (CSRGraph, NodeStream, or a disk-backed stream); "
        "materialize one-shot streams first"
    )


# -------------------------------------------------------------- merge pass


def _merge_leg(shard: StreamShard, block: np.ndarray, starts: np.ndarray,
               k: int) -> "tuple[np.ndarray, float, int, int, int]":
    """Replay one shard against the merged labels: exact per-block float64
    loads of the shard's own nodes (id-order accumulation) and the
    cross-shard cut charged in this range — each cross edge (u, v) with
    u < v counted once, at v (the one-side charging of
    `core.restream._replay_totals`), restricted to endpoints in different
    shards because the intra-shard part is already exact in the workers'
    streamed cuts."""
    loads = np.zeros(k, dtype=np.float64)
    cut_cross = 0.0
    peak = 0
    my = int(np.searchsorted(starts, shard.lo, side="right")) - 1
    for v, nbrs, w, node_w in shard:
        loads[block[v]] += float(node_w)
        if nbrs.size:
            nb = nbrs.astype(np.int64)
            cross = (
                (nb < v)
                & (np.searchsorted(starts, nb, side="right") - 1 != my)
                & (block[nb] != block[v])
            )
            if cross.any():
                cut_cross += float(np.sum(w[cross].astype(np.float64)))
        if shard.resident_bytes > peak:
            peak = shard.resident_bytes
    return loads, cut_cross, shard.bytes_read, peak, shard.io_retries


def _merge_graph(g: CSRGraph, block: np.ndarray, starts: np.ndarray,
                 k: int) -> "tuple[np.ndarray, float]":
    """Vectorized whole-graph merge for in-memory sources: same id-order
    loads accumulation (np.add.at), same one-side cross-shard charging."""
    loads = np.zeros(k, dtype=np.float64)
    np.add.at(loads, block, g.node_w.astype(np.float64))
    src = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(g.indptr))
    nb = g.indices.astype(np.int64)
    shard_of = np.searchsorted(starts, np.arange(g.n, dtype=np.int64), side="right") - 1
    cross = (nb < src) & (shard_of[nb] != shard_of[src]) & (block[nb] != block[src])
    cut_cross = float(np.sum(g.edge_w[cross].astype(np.float64)))
    return loads, cut_cross


# --------------------------------------------------------------- the pool


class ShardPool:
    """W shard workers with join-on-every-exit-path lifecycle.

    ``thread`` backend: each worker is a thread running the sequential
    driver directly, on `launch_ctx` — the caller's ``(device, stream)``
    for a card, empty for the host.  ``process`` backend: each worker is a
    forked child speaking a pipe protocol — ("sync", delta) / others back,
    then ("drive_done", labels, stats, final_delta, rounds), then the
    parent sends ("merge", block) and gets ("merge_done", loads, cut,
    bytes, peak, retries) — to a proxy thread in the parent that runs the
    same `SharedLoads` barrier the thread backend does.  `run()` waits for
    every worker, joins everything and raises `ShardWorkerError` if any
    worker failed; `close()` aborts a running pool and still joins
    everything (mid-run consumer abandon)."""

    def __init__(self, factories, ranges, cfg: BuffCutConfig, *,
                 load_sync_every: int, prefetch_batches: int,
                 backend: str, merge_in_worker: bool, launch_ctx: tuple = ()):
        self.factories = factories
        self.ranges = ranges
        self.cfg = cfg
        self.every = load_sync_every
        self.prefetch = prefetch_batches
        self.backend = backend
        self.merge_in_worker = merge_in_worker
        self.launch_ctx = launch_ctx
        self.W = len(ranges)
        n = 0 if not ranges else ranges[-1][1]
        self.starts = np.asarray([lo for lo, _ in ranges], dtype=np.int64)
        self.shared = SharedLoads(self.W, cfg.k)
        self.gate = _Gate(self.W, self.shared)
        self._host_turn = threading.Lock()  # see _Turn
        self.block = np.full(n, -1, dtype=np.int64)
        self.drive: list = [None] * self.W   # (stats, rounds) per worker
        self.merge: list = [None] * self.W   # (loads, cut, bytes, peak, retries)
        self.errors: list = [None] * self.W
        self._threads: list[threading.Thread] = []
        self._procs: list = [None] * self.W
        self._conns: list = [None] * self.W
        self._started = False

    # ------------------------------------------------------ thread worker
    def _drive_thread(self, w: int) -> None:
        turn = _Turn(self._host_turn, self.shared)

        def exchange(delta, rnd):
            self.shared.publish(w, delta)
            turn.give()
            others = self.shared.others_at(w, rnd)
            turn.take()
            return others

        hook = _LoadSync(exchange, self.every, self.cfg.k) if self.W > 1 else None
        try:
            turn.take()
            with contextlib.ExitStack() as launch_on:
                if self.launch_ctx:
                    import torch  # once a worker; only thread workers on a card

                    launch_on.enter_context(torch.cuda.device(self.launch_ctx[0]))
                    launch_on.enter_context(torch.cuda.stream(self.launch_ctx[1]))
                shard = self.factories[w]()
                labels, stats = _buffcut_partition(
                    shard, self.cfg, prefetch_batches=self.prefetch, on_batch=hook
                )
            fl = np.asarray(stats.block_loads, dtype=np.float64)
            self.shared.finish(w, hook.final_delta(fl) if hook else fl)
            lo, hi = self.ranges[w]
            self.block[lo:hi] = labels[lo:hi]
            self.drive[w] = (stats, hook.rounds if hook else 0)
            turn.give()
            self.gate.arrive_and_wait()
            if self.merge_in_worker:
                turn.take()
                self.merge[w] = _merge_leg(
                    self.factories[w](), self.block, self.starts, self.cfg.k
                )
        finally:
            turn.give()

    # ----------------------------------------------------- process worker
    def _drive_process(self, w: int) -> None:
        conn, proc = self._conns[w], self._procs[w]

        def recv():
            while not conn.poll(_POLL_S):
                if self.shared.aborted is not None:
                    raise _Aborted(self.shared.aborted)
                if not proc.is_alive():
                    # no pending message and the child is gone: crashed
                    if not conn.poll(0):
                        raise ShardWorkerError(
                            f"shard worker {w} died (exit code {proc.exitcode}) "
                            "without reporting an error"
                        )
            try:
                return conn.recv()
            except EOFError:
                raise ShardWorkerError(
                    f"shard worker {w} closed its pipe mid-protocol "
                    f"(exit code {proc.exitcode})"
                ) from None

        rnd = 0
        while True:
            msg = recv()
            if msg[0] == "sync":
                self.shared.publish(w, msg[1])
                conn.send(self.shared.others_at(w, rnd))
                rnd += 1
            elif msg[0] == "drive_done":
                _, labels, stats_d, final_delta, rounds = msg
                self.shared.finish(w, final_delta)
                lo, hi = self.ranges[w]
                self.block[lo:hi] = labels
                self.drive[w] = (StreamStats.from_dict(stats_d), rounds)
                break
            elif msg[0] == "err":
                raise ShardWorkerError(f"shard worker {w} failed:\n{msg[1]}")
            else:  # pragma: no cover - protocol guard
                raise ShardWorkerError(f"shard worker {w}: bad message {msg[0]!r}")
        self.gate.arrive_and_wait()
        if self.merge_in_worker:
            conn.send(("merge", self.block))
            msg = recv()
            if msg[0] == "err":
                raise ShardWorkerError(f"shard worker {w} merge failed:\n{msg[1]}")
            self.merge[w] = tuple(msg[1:])
        else:
            conn.send(("exit",))

    # ---------------------------------------------------------- lifecycle
    def _run(self, w: int) -> None:
        try:
            if self.backend == "thread":
                self._drive_thread(w)
            else:
                self._drive_process(w)
        except _Aborted as e:
            self.errors[w] = e
        except BaseException as e:
            self.errors[w] = e
            self.shared.abort(f"shard worker {w} failed: {type(e).__name__}: {e}")
        finally:
            conn = self._conns[w]
            if conn is not None:
                conn.close()

    def start(self) -> None:
        if self._started:
            raise RuntimeError("pool already started")
        self._started = True
        if self.backend == "process":
            try:
                ctx = multiprocessing.get_context("fork")
            except ValueError:  # pragma: no cover - non-POSIX
                raise ValueError(
                    "backend='process' needs fork-capable multiprocessing "
                    "(POSIX); use backend='thread'"
                ) from None
            for w in range(self.W):
                parent_conn, child_conn = ctx.Pipe(duplex=True)
                proc = ctx.Process(
                    target=_child_main,
                    args=(child_conn, w, self.factories[w], self.cfg,
                          self.every, self.prefetch, self.starts,
                          self.W, self.merge_in_worker),
                    name=f"shard-worker-{w}",
                    daemon=True,
                )
                with warnings.catch_warnings():
                    # Python warns about fork in a multi-threaded process; the
                    # children run only the host engine's numpy code
                    warnings.filterwarnings("ignore", message=".*fork.*",
                                            category=DeprecationWarning)
                    proc.start()
                child_conn.close()
                self._procs[w] = proc
                self._conns[w] = parent_conn
        for w in range(self.W):
            t = threading.Thread(
                target=self._run, args=(w,), name=f"shard-worker-{w}", daemon=True
            )
            self._threads.append(t)
            t.start()

    def _join_all(self) -> None:
        """Shutdown-path join: bounded by `_JOIN_TIMEOUT_S` per worker, and
        a worker still alive after it is aborted."""
        for t in self._threads:
            t.join(timeout=_JOIN_TIMEOUT_S)
        for t in self._threads:
            if t.is_alive():  # pragma: no cover - stuck worker backstop
                self.shared.abort("pool shutdown")
                t.join(timeout=_JOIN_TIMEOUT_S)
        for proc in self._procs:
            if proc is None:
                continue
            proc.join(timeout=_JOIN_TIMEOUT_S)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=_JOIN_TIMEOUT_S)

    def run(self) -> None:
        """Block until every worker drove and merged; join everything; raise
        the first real worker failure (worker-index order) if any.

        The wait has no deadline: a failing worker aborts the barrier, which
        ends every other worker at its next sync, so the wait ends on every
        error path too.  (The reference joins here with the shutdown
        deadline and so aborts any run whose workers outlast it.)"""
        try:
            for t in self._threads:
                t.join()
        finally:
            self.close()
        for e in self.errors:
            if e is not None and not isinstance(e, _Aborted):
                raise ShardWorkerError(
                    f"sharded partition failed: {e}"
                ) from e
        msg = self.shared.aborted
        if msg is not None:
            # abort without a recorded root error: consumer-driven close()
            raise ShardWorkerError(f"sharded partition aborted: {msg}")
        if self.block.size and (self.block < 0).any():  # pragma: no cover
            raise ShardWorkerError("merged labels incomplete after all workers")

    def close(self) -> None:
        """Abort (if still running) and join every thread and child process.
        Idempotent; safe to call mid-run (consumer abandon)."""
        if any(t.is_alive() for t in self._threads):
            self.shared.abort("pool closed by consumer")
        self._join_all()


def _child_main(conn, w, factory, cfg, every, prefetch, starts, workers,
                merge_in_worker):  # pragma: no cover - runs in a fork
    """Forked shard worker: drive the shard (load syncs via the pipe), send
    labels + stats, then serve the merge request against the parent's
    merged label array."""
    try:
        def exchange(delta, rnd):
            conn.send(("sync", delta))
            return conn.recv()  # parent closes the pipe on abort -> EOFError

        hook = _LoadSync(exchange, every, cfg.k) if workers > 1 else None
        shard = factory()
        labels, stats = _buffcut_partition(
            shard, cfg, prefetch_batches=prefetch, on_batch=hook
        )
        fl = np.asarray(stats.block_loads, dtype=np.float64)
        conn.send((
            "drive_done", labels[shard.lo:shard.hi], stats.to_dict(),
            hook.final_delta(fl) if hook else fl,
            hook.rounds if hook else 0,
        ))
        msg = conn.recv()
        if msg[0] == "merge":
            out = _merge_leg(factory(), msg[1], starts, cfg.k)
            conn.send(("merge_done", *out))
    except BaseException:
        try:
            conn.send(("err", traceback.format_exc()))
        except (OSError, ValueError):
            # parent gone / pipe closed: nothing left to report the error to
            pass
    finally:
        conn.close()


# ---------------------------------------------------------------- the API


SHARD_BACKENDS = ("thread", "process")


def _slim_stats(stats: StreamStats, rounds: int, lo: int, hi: int) -> dict:
    return {
        "range": [int(lo), int(hi)],
        "sync_rounds": int(rounds),
        "cut_weight": float(stats.cut_weight),
        "n_batches": int(stats.n_batches),
        "n_hubs": int(stats.n_hubs),
        "runtime_s": float(stats.runtime_s),
        "ml_time_s": float(stats.ml_time_s),
        "peak_resident_bytes": int(stats.peak_resident_bytes),
        "stream_bytes_read": int(stats.stream_bytes_read),
        "io_retries": int(stats.io_retries),
    }


def _launch_context(cfg: BuffCutConfig, backend: str) -> tuple:
    """Check the device once, in the calling thread, and return the
    ``(device, stream)`` the thread workers launch on (empty for the
    host).  Refuses the process backend, before anything forks, for every
    configuration whose V-cycle is not the host's numpy code: the card's
    context and torch's CPU thread pool do not survive fork.  Nothing here
    imports torch before the refusal or on the `sparse` path, so a process
    backend forks from a parent that has not loaded it."""
    on_card = str(cfg.ml.device).startswith("cuda")
    host_numpy = cfg.ml.engine == "sparse" or (cfg.ml.engine == "auto" and not on_card)
    if backend == "process" and not host_numpy:
        raise ValueError(
            f"backend='process' cannot run engine {cfg.ml.engine!r} on "
            f"{cfg.ml.device!r}: its V-cycle runs torch ops, and neither a CUDA "
            "context nor torch's thread pool survives fork; use "
            "backend='thread' or engine='sparse'"
        )
    if cfg.ml.engine == "sparse":
        return ()
    dev = preflight(cfg.ml.device)
    if dev.type != "cuda":
        return ()
    import torch

    caller = torch.cuda.current_stream(dev)
    return (caller.device, caller)


def shard_partition(
    source: "CSRGraph | NodeStreamBase",
    cfg: BuffCutConfig,
    *,
    workers: int,
    load_sync_every: int = 8,
    backend: str = "thread",
    prefetch_batches: int = 0,
) -> "tuple[np.ndarray, StreamStats, dict]":
    """Partition `source` with `workers` sharded BuffCut drivers.

    Returns ``(labels, stats, info)``: complete global labels, a merged
    `StreamStats` whose ``cut_weight`` / ``block_loads`` are *exact* (from
    the merge replay — ready to seed `restream_refine`), and a provenance
    dict (ranges, per-worker stats, sync rounds, phase timings, the
    intra/cross cut split).  W=1 runs the sequential driver unchanged —
    bit-identical labels and stats, no merge pass.

    The device engines run on `cfg.ml.device` ("cuda" by default): the
    device is checked and the kernels built once before any worker starts,
    and the workers launch on the caller's current CUDA stream.
    """
    if workers < 1:
        raise ValueError(f"workers must be >= 1, got {workers}")
    if load_sync_every < 1:
        raise ValueError(f"load_sync_every must be >= 1, got {load_sync_every}")
    if backend not in SHARD_BACKENDS:
        raise ValueError(
            f"unknown shard backend {backend!r}: pick one of {SHARD_BACKENDS}"
        )
    launch_ctx = _launch_context(cfg, backend)
    stream = as_node_stream(source)
    n = stream.n
    ranges = shard_ranges(n, workers)
    t0 = time.perf_counter()
    info: dict = {
        "workers": int(workers),
        "effective_workers": len(ranges),
        "backend": backend,
        "load_sync_every": int(load_sync_every),
        "ranges": [[int(lo), int(hi)] for lo, hi in ranges],
    }
    base_retries = stream.io_retries
    if len(ranges) == 1:
        # one shard is the sequential driver, bit for bit
        labels, stats = _buffcut_partition(
            stream, cfg, prefetch_batches=prefetch_batches
        )
        stats.runtime_s = time.perf_counter() - t0
        info.update({
            "split_s": 0.0, "pool_s": stats.runtime_s,
            "cut_pre_reconcile": stats.cut_weight,
            "cut_intra_shard": stats.cut_weight, "cut_cross_shard": 0.0,
            "sync_rounds": [0],
            "per_worker": [_slim_stats(stats, 0, 0, n)],
        })
        return labels, stats, info

    graph = stream._g if isinstance(stream, NodeStream) else None
    merge_in_worker = graph is None
    factories, split_bytes = _make_factories(stream, ranges)
    split_retries = stream.io_retries - base_retries
    split_s = time.perf_counter() - t0

    pool = ShardPool(
        factories, ranges, cfg,
        load_sync_every=load_sync_every, prefetch_batches=prefetch_batches,
        backend=backend, merge_in_worker=merge_in_worker, launch_ctx=launch_ctx,
    )
    t1 = time.perf_counter()
    pool.start()
    pool.run()
    pool_s = time.perf_counter() - t1

    block = pool.block
    per = [d for d, _ in pool.drive]
    rounds = [r for _, r in pool.drive]
    if merge_in_worker:
        loads = np.zeros(cfg.k, dtype=np.float64)
        cut_cross = 0.0
        merge_bytes = 0
        merge_peak = 0
        merge_retries = 0
        for leg_loads, leg_cut, leg_bytes, leg_peak, leg_retries in pool.merge:
            loads = loads + leg_loads
            cut_cross += leg_cut
            merge_bytes += int(leg_bytes)
            merge_peak = max(merge_peak, int(leg_peak))
            merge_retries += int(leg_retries)
    else:
        loads, cut_cross = _merge_graph(graph, block, pool.starts, cfg.k)
        merge_bytes = 0
        merge_peak = 0
        merge_retries = 0

    cut_intra = 0.0
    for s in per:
        cut_intra += float(s.cut_weight)
    cut = cut_intra + cut_cross
    n_total = stream.n_total
    stats = StreamStats(
        runtime_s=time.perf_counter() - t0,
        ml_time_s=sum(s.ml_time_s for s in per),
        n_batches=sum(s.n_batches for s in per),
        n_hubs=sum(s.n_hubs for s in per),
        ier_per_batch=[x for s in per for x in s.ier_per_batch],
        peak_mem_items=max(s.peak_mem_items for s in per),
        evictions=[x for s in per for x in s.evictions],
        cut_weight=cut,
        balance=float(loads.max() / (n_total / cfg.k)) if n_total > 0 else 1.0,
        # workers run concurrently: the honest bound is the sum of their peaks
        peak_resident_bytes=sum(s.peak_resident_bytes for s in per) + merge_peak,
        stream_bytes_read=(
            split_bytes + sum(s.stream_bytes_read for s in per) + merge_bytes
        ),
        block_loads=loads.tolist(),
        io_retries=(
            split_retries + sum(s.io_retries for s in per) + merge_retries
        ),
    )
    info.update({
        "split_s": split_s, "pool_s": pool_s,
        "cut_pre_reconcile": cut,
        "cut_intra_shard": cut_intra, "cut_cross_shard": cut_cross,
        "split_bytes": int(split_bytes), "merge_bytes": int(merge_bytes),
        "sync_rounds": [int(r) for r in rounds],
        "per_worker": [
            _slim_stats(s, r, lo, hi)
            for s, r, (lo, hi) in zip(per, rounds, ranges)
        ],
    })
    return block, stats, info
