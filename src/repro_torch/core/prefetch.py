"""Double-buffered stream prefetcher — stage T1 of the pipelined hot path.

`PrefetchStream` wraps any `NodeStreamBase` and moves record production
onto a background thread: while the consumer (a driver's score/evict/assign
loop) processes block *i*, the pump thread is already producing block
*i+1*.  Records travel through a bounded queue in **blocks** (by default
the driver's δ-batch size), not one at a time: a `queue.Queue` handoff
costs microseconds, which per record would eat the whole gain.

It changes *when* records are produced, never *what* they contain:

* Records are yielded in the order the inner stream produces them, so
  labels downstream are bit-identical to the unwrapped stream.
* `tell()` returns the inner stream's resume token captured right after the
  last record the **consumer** has seen, not however far ahead the pump
  has read.
* `resident_bytes` counts the inner stream's residency **plus** every
  record staged in the queue or in the consumer's current block, bounded
  by `(depth + 1) * block` records.
* Pump exceptions are re-raised in the consumer at the position they
  occurred, and the pump thread is joined on every exit path — normal
  exhaustion, consumer `break`, consumer exception — so no run leaks a
  thread.

`depth` is `PipelineConfig.prefetch_batches`: 0 means "do not wrap"
(`maybe_prefetch` returns the stream), 1 is classic double buffering, more
deepens the read-ahead window.  The same as `repro.core.prefetch`.
"""
from __future__ import annotations

import queue
import threading
from collections.abc import Iterator

import numpy as np

from repro_torch.graphs.stream import NodeStreamBase

# queue poll granularity: how often a blocked pump/consumer re-checks the
# stop event; it only bounds shutdown latency
_POLL_S = 0.05
_JOIN_TIMEOUT_S = 5.0

# kinds of queue items
_BLOCK = 0
_DONE = 1
_ERR = 2


def _record_bytes(rec: tuple) -> int:
    """Staging cost of one queued record: its two arrays plus tuple/token
    overhead."""
    _, nbrs, w, _ = rec
    return int(nbrs.nbytes + w.nbytes + 64)


class PrefetchStream(NodeStreamBase):
    """Background-thread read-ahead over any node stream, block-granular.

    One iteration at a time: starting a new `__iter__`/`iter_from`/`blocks`
    shuts down the previous pump first.
    """

    def __init__(self, inner: NodeStreamBase, *, depth: int, block: int = 256):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        if block < 1:
            raise ValueError(f"prefetch block must be >= 1, got {block}")
        self._inner = inner
        self._depth = int(depth)
        self._block = int(block)
        self.n = inner.n
        self.m = inner.m
        self._q: queue.Queue | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._staged_lock = threading.Lock()
        self._staged_bytes = 0
        self._last_pos: dict | None = None

    # ------------------------------------------------------- forwarded state
    @property
    def n_total(self) -> float:
        return self._inner.n_total

    @property
    def m_total(self) -> float:
        return self._inner.m_total

    @property
    def resident_bytes(self) -> int:
        return self._inner.resident_bytes + self._staged_bytes

    @property
    def bytes_read(self) -> int:
        return self._inner.bytes_read

    @property
    def io_retries(self) -> int:
        return getattr(self._inner, "io_retries", 0)

    def tell(self) -> dict:
        if self._last_pos is None:
            # no record consumed yet: the inner cursor is the pump's
            raise NotImplementedError(
                "PrefetchStream.tell() before the first consumed record"
            )
        return dict(self._last_pos)

    # ------------------------------------------------------------- the pump
    def _pump(self, records: Iterator, q: queue.Queue, stop: threading.Event) -> None:
        """Drain `records` into `q` in blocks, capturing the inner stream's
        resume token after every record (tokens ride with the records, so
        the consumer-side `tell()` is exact)."""
        inner = self._inner
        block_n = self._block
        recs: list = []
        toks: list = []
        nbytes = 0
        try:
            for rec in records:
                try:
                    toks.append(inner.tell())
                except NotImplementedError:
                    toks.append(None)
                recs.append(rec)
                nbytes += _record_bytes(rec)
                if len(recs) == block_n:
                    if not self._put(q, stop, (_BLOCK, recs, toks, nbytes)):
                        return
                    recs, toks, nbytes = [], [], 0
            if recs and not self._put(q, stop, (_BLOCK, recs, toks, nbytes)):
                return
            self._put(q, stop, (_DONE, None, None, 0))
        except BaseException as exc:  # noqa: BLE001 — forwarded, not dropped
            self._put(q, stop, (_ERR, exc, None, 0))

    def _put(self, q: queue.Queue, stop: threading.Event, item: tuple) -> bool:
        if item[0] == _BLOCK:
            with self._staged_lock:
                self._staged_bytes += item[3]
        while not stop.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        # the consumer went away: undo this block's staging
        if item[0] == _BLOCK:
            with self._staged_lock:
                self._staged_bytes -= item[3]
        return False

    def _start(self, records: Iterator) -> queue.Queue:
        self._shutdown()
        self._stop = threading.Event()
        with self._staged_lock:
            self._staged_bytes = 0
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        t = threading.Thread(target=self._pump, args=(records, q, self._stop),
                             name="prefetch-pump", daemon=True)
        self._q, self._thread = q, t
        t.start()
        return q

    def _shutdown(self) -> None:
        """Stop and join the active pump (idempotent, on every exit path);
        drains the queue so a pump blocked on put() wakes up."""
        t, q = self._thread, self._q
        if t is None:
            return
        self._stop.set()
        while t.is_alive():
            try:
                if q is not None:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=_POLL_S)
        t.join(timeout=_JOIN_TIMEOUT_S)
        self._thread = None
        self._q = None
        with self._staged_lock:
            self._staged_bytes = 0

    # ---------------------------------------------------------- consumption
    def blocks(self, pos: dict | None = None) -> Iterator[tuple[list, list]]:
        """Yield (records, tokens) blocks — the pipelined driver's path.
        `tokens[i]` is the resume token after `records[i]` (None when the
        inner stream is not seekable)."""
        records = iter(self._inner) if pos is None else self._inner.iter_from(dict(pos))
        self._last_pos = dict(pos) if pos is not None else None
        q = self._start(records)
        try:
            while True:
                try:
                    kind, a, b, nbytes = q.get(timeout=_POLL_S)
                except queue.Empty:
                    continue
                if kind == _DONE:
                    return
                if kind == _ERR:
                    raise a
                try:
                    yield a, b
                finally:
                    # the consumer owns the tokens; only the staging retires
                    with self._staged_lock:
                        self._staged_bytes -= nbytes
        finally:
            self._shutdown()

    def close(self) -> None:
        """Stop and join the pump thread; safe at any time, also when no
        iteration started.  Drivers call it from their ``finally``."""
        self._shutdown()

    def _iter_records(self, pos: dict | None) -> Iterator:
        # the token is published BEFORE the yield, so tell() while the
        # consumer processes record i gives the token after record i
        for recs, toks in self.blocks(pos):
            for i, rec in enumerate(recs):
                if toks[i] is not None:
                    self._last_pos = toks[i]
                yield rec

    def __iter__(self) -> Iterator[tuple[int, np.ndarray, np.ndarray, float]]:
        return self._iter_records(None)

    def iter_from(self, pos: dict) -> Iterator[tuple[int, np.ndarray, np.ndarray, float]]:
        return self._iter_records(dict(pos))


def maybe_prefetch(stream: NodeStreamBase, prefetch_batches: int,
                   block: int) -> NodeStreamBase:
    """Wrap `stream` in a PrefetchStream when `prefetch_batches > 0` (and
    it is not one already); the one entry point every driver uses, so the
    knob means the same everywhere."""
    if prefetch_batches <= 0 or isinstance(stream, PrefetchStream):
        return stream
    return PrefetchStream(stream, depth=prefetch_batches, block=block)
