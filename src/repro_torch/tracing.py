"""Spans inside the program, kept in memory; off by default.

    from repro_torch import tracing
    tracing.enable()
    partition(g, driver="heistream", k=32)
    records = tracing.drain()      # every span that ended, oldest first
    tracing.disable()

A span is a `with` block around one stage of the work::

    with tracing.span("vcycle.pack") as s:
        ...
        s.add("h2d_bytes", a.nbytes)

Each `Record` holds the span's name, its start and end on
`time.perf_counter_ns()`, its id and its parent's (0 for a root), the
thread that ran it, and its integer counts.  The stack of open spans is
per thread, so a worker thread's spans nest under that thread's own.
While tracing is off, `span` returns one shared no-op span: no clock read
and no allocation.

`ranges(True)` makes each span a `torch.profiler.record_function` range as
well, so the spans land in a profiler trace on the profiler's own clock;
torch is imported there only, and this module stays off torch's import
path.

The spans of the batch path (every span of a batch descends from its
`driver.batch`):

    driver.batch     one δ-batch of `core/heistream.py`
    batch_model.run  the batch model (`core/batch_model.py`), with its
                     stages .gather (two spans: the CSR slice; the local
                     map and the internal split), .aux (the aux-edge
                     weights) and .csr (`CSRGraph.from_edges`)
    vcycle.run       the device V-cycle (`core/multilevel_torch.py`), with
                     its stages .pack (the upload and the padding; counts
                     `h2d_bytes`, and `pack_kernel` for each `csr_pack`
                     launch on a card), .coarsen (one a level tried), .initial,
                     .refine (one a level) and .fetch (the labels back);
                     `vcycle.sync` marks each point where the host waits for
                     the card, inside the stage that waits
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time


@dataclasses.dataclass(slots=True)
class Record:
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int        # 0 for a root
    thread: int
    counts: dict       # key -> int


class _State:
    def __init__(self) -> None:
        self.on = False
        self.ranges = False
        self.records: list[Record] = []
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.local = threading.local()

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s


_STATE = _State()


def _record_function(name: str):
    from torch.profiler import record_function  # repro: noqa RPR001 -- ranges on: a profiled run

    return record_function(name)


class _Span:
    __slots__ = ("name", "counts", "id", "parent", "start_ns", "_range")

    def __init__(self, name: str) -> None:
        self.name = name
        self.counts: dict = {}
        self._range = None

    def __enter__(self) -> "_Span":
        stack = _STATE.stack()
        self.id = next(_STATE.ids)
        self.parent = stack[-1].id if stack else 0
        stack.append(self)
        if _STATE.ranges:
            self._range = _record_function(self.name)
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        _STATE.stack().pop()
        rec = Record(self.name, self.start_ns, end_ns, self.id, self.parent,
                     threading.get_ident(), self.counts)
        with _STATE.lock:
            _STATE.records.append(rec)
        return False

    def add(self, key: str, n: int) -> None:
        self.counts[key] = self.counts.get(key, 0) + n


class _NoSpan:
    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def add(self, key: str, n: int) -> None:
        pass


NO_SPAN = _NoSpan()


def span(name: str):
    """A span named `name` while tracing is on, else the shared `NO_SPAN`."""
    return _Span(name) if _STATE.on else NO_SPAN


def add(key: str, n: int) -> None:
    """Add `n` to the count `key` of this thread's innermost open span, if any."""
    stack = getattr(_STATE.local, "stack", None)
    if stack:
        stack[-1].add(key, n)


def enable() -> None:
    _STATE.on = True


def disable() -> None:
    _STATE.on = False


def ranges(on: bool) -> None:
    """Whether each span is also a `torch.profiler.record_function` range."""
    _STATE.ranges = bool(on)


def drain() -> list[Record]:
    """The records of every span ended since the last drain; clears them."""
    with _STATE.lock:
        out, _STATE.records = _STATE.records, []
    return out
