"""ServeSession — request batching across concurrent clients.

A `PartitionService` is lock-safe but sequential; this module gives it the
front door: clients submit verb requests from any thread, a bounded queue
feeds one worker thread that owns the service, and consecutive queued
lookups are coalesced into a single label gather (one fancy-index instead
of q small ones — the serving-path analogue of the drivers' δ-batching).

Lifecycle follows the pipelined driver's discipline (core/pipeline.py):

* the queue is bounded, so a slow service back-pressures submitters
  instead of growing an unbounded backlog;
* the worker polls with a short timeout and honors a stop event, so
  shutdown never hinges on a sentinel surviving a full queue;
* `close()` joins with a timeout on every exit path and raises loudly if
  the worker is wedged or died — with the worker's root-cause exception
  chained, never a bare "thread stopped";
* per-request errors (bad node id, absent edge) fail *that request's*
  future and the worker keeps serving; only infrastructure failures kill
  the loop, and then every pending future is failed with the root cause.

The worker launches the refines' V-cycles on the device and current CUDA
stream of the thread that created the session, captured at construction
(torch keeps both per thread).

Use as a context manager::

    with ServeSession(service) as sess:
        labels = sess.lookup([0, 1, 2])
        sess.update(insert_edges=[(0, 9)])
        sess.refine()
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
from concurrent.futures import Future

import numpy as np

from repro_torch.serve.service import PartitionService

_POLL_S = 0.05
_JOIN_TIMEOUT_S = 5.0

_VERBS = ("lookup", "update", "refine")

_POISON = object()


@dataclasses.dataclass
class _Request:
    kind: str
    payload: object
    future: Future


class ServeSession:
    """Bounded-queue, single-worker front door for a `PartitionService`.

    `submit_*` methods enqueue and return a `concurrent.futures.Future`;
    the blocking `lookup`/`update`/`refine` wrappers wait for the result.
    Requests execute in strict FIFO submission order (coalesced lookups
    preserve per-request result boundaries), so a given request sequence is
    as deterministic as the service itself.
    """

    def __init__(
        self,
        service: PartitionService,
        *,
        queue_depth: int = 256,
        coalesce_lookups: bool = True,
        name: str = "serve-worker",
    ):
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        self.service = service
        self._q: "queue.Queue[object]" = queue.Queue(maxsize=queue_depth)
        self._coalesce = bool(coalesce_lookups)
        self._stop = threading.Event()
        self._closed = False
        self._error: "BaseException | None" = None
        self.stats = {"requests": 0, "lookups": 0, "updates": 0,
                      "refines": 0, "coalesced_lookups": 0}
        # the creator's device and current stream, for the worker's launches
        self._launch_ctx: tuple = ()
        ml = service.cfg.ml
        if ml.engine != "sparse" and str(ml.device).startswith("cuda"):
            import torch  # once a session: keeps torch off the import path

            caller = torch.cuda.current_stream(torch.device(ml.device))
            self._launch_ctx = (caller.device, caller)
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- clients
    def _submit(self, kind: str, payload) -> Future:
        if self._closed:
            raise RuntimeError("ServeSession is closed")
        if self._error is not None:
            raise RuntimeError(
                "ServeSession worker died; no further requests accepted"
            ) from self._error
        fut: Future = Future()
        try:
            self._q.put(_Request(kind, payload, fut), timeout=_JOIN_TIMEOUT_S)
        except queue.Full as e:
            if self._error is not None:
                raise RuntimeError(
                    "ServeSession worker died with a full queue"
                ) from self._error
            raise RuntimeError(
                f"ServeSession queue stayed full for {_JOIN_TIMEOUT_S:.0f}s "
                "— the service is not keeping up; raise queue_depth or slow "
                "the submitters"
            ) from e
        return fut

    def submit_lookup(self, nodes) -> Future:
        return self._submit("lookup", np.asarray(nodes, dtype=np.int64).ravel())

    def submit_update(self, *, add_nodes=None, insert_edges=None,
                      delete_edges=None) -> Future:
        return self._submit("update", {
            "add_nodes": add_nodes, "insert_edges": insert_edges,
            "delete_edges": delete_edges,
        })

    def submit_refine(self, budget: "int | None" = None) -> Future:
        return self._submit("refine", budget)

    def lookup(self, nodes) -> np.ndarray:
        return self.submit_lookup(nodes).result()

    def update(self, **kwargs) -> dict:
        return self.submit_update(**kwargs).result()

    def refine(self, budget: "int | None" = None) -> dict:
        return self.submit_refine(budget).result()

    # -------------------------------------------------------------- worker
    def _next(self):
        """Blocking dequeue honoring poison and the stop event."""
        while True:
            try:
                req = self._q.get(timeout=_POLL_S)
            except queue.Empty:
                if self._stop.is_set():
                    return None
                continue
            if req is _POISON:
                return None
            return req

    def _execute(self, req: _Request) -> None:
        try:
            if req.kind == "lookup":
                out = self.service.lookup(req.payload)
            elif req.kind == "update":
                out = self.service.update(**req.payload)
            elif req.kind == "refine":
                out = self.service.refine(req.payload)
            else:  # pragma: no cover - submit() only enqueues known verbs
                raise RuntimeError(f"unknown verb {req.kind!r}")
            self.stats["requests"] += 1
            self.stats[req.kind + "s"] += 1
            req.future.set_result(out)
        except Exception as e:  # per-request failure: fail it, keep serving
            self.stats["requests"] += 1
            req.future.set_exception(e)

    def _lookup_batch(self, batch: "list[_Request]") -> None:
        """One coalesced gather for consecutive queued lookups; on any
        error, fall back to per-request execution so the failure lands on
        the offending request only."""
        if len(batch) == 1:
            self._execute(batch[0])
            return
        try:
            sizes = [r.payload.shape[0] for r in batch]
            flat = self.service.lookup(np.concatenate([r.payload for r in batch]))
            off = 0
            for r, sz in zip(batch, sizes):
                r.future.set_result(flat[off:off + sz])
                off += sz
            self.stats["requests"] += len(batch)
            self.stats["lookups"] += len(batch)
            self.stats["coalesced_lookups"] += len(batch) - 1
        except Exception:
            for r in batch:
                self._execute(r)

    def _run(self) -> None:
        try:
            with contextlib.ExitStack() as launch_on:
                if self._launch_ctx:
                    import torch

                    launch_on.enter_context(torch.cuda.device(self._launch_ctx[0]))
                    launch_on.enter_context(torch.cuda.stream(self._launch_ctx[1]))
                self._serve()
        except BaseException as e:  # infrastructure failure: fail everything
            self._error = e
            self._fail_pending(RuntimeError("ServeSession worker died"), e)

    def _serve(self) -> None:
        while True:
            req = self._next()
            if req is None:
                return
            if req.kind == "lookup" and self._coalesce:
                batch = [req]
                tail = None
                stop_after = False
                while True:
                    try:
                        nxt = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is _POISON:
                        stop_after = True
                        break
                    if nxt.kind == "lookup":
                        batch.append(nxt)
                        continue
                    tail = nxt
                    break
                self._lookup_batch(batch)
                if tail is not None:
                    self._execute(tail)
                if stop_after:
                    return
            else:
                self._execute(req)

    def _fail_pending(self, err: Exception, cause: "BaseException | None" = None) -> None:
        if cause is not None:
            err.__cause__ = cause
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                return
            if req is _POISON:
                continue
            req.future.set_exception(err)

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        """Stop accepting requests, drain-stop the worker, join with a
        timeout, and surface the worker's root cause if it died.
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        try:
            self._q.put(_POISON, timeout=_JOIN_TIMEOUT_S)
        except queue.Full:
            pass  # worker (if alive) still sees the stop event on next poll
        self._thread.join(_JOIN_TIMEOUT_S)
        if self._thread.is_alive():
            raise RuntimeError(
                f"ServeSession worker failed to stop within {_JOIN_TIMEOUT_S:.0f}s"
            )
        self._fail_pending(RuntimeError("ServeSession closed"))
        if self._error is not None:
            raise RuntimeError(
                "ServeSession worker died during serving"
            ) from self._error

    def __enter__(self) -> "ServeSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
