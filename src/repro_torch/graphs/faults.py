"""Deterministic fault injection for the hardened stream IO.

`FaultyOpener` is a drop-in `open` replacement for the `opener` hook on
`DiskNodeStream` / the chunk readers: every file it opens is wrapped in a
`FaultyFile` that consults a shared `FaultSchedule` before each read.  The
schedule is keyed by global call index (opens and reads each count from 0
across *all* files opened through the same opener), so fault sequences are
exactly reproducible — no randomness, no timing.

Supported faults:

* transient errors — listed read indices raise ``OSError(errno)`` once
  (the next attempt at the same position succeeds); listed open indices do
  the same for `opener()` calls.  These are what the bounded
  retry-with-backoff in stream_io.py must absorb.
* short reads — listed read indices return only half the bytes the kernel
  would have (file position rewound accordingly), which a correct chunked
  reader must handle by re-reading.
* corrupted reads — listed read indices XOR-flip a byte in the returned
  chunk.  Packed v2 CRC sections must turn this into `StreamFormatError`,
  never a wrong partition.
* truncation — reads at or past ``truncate_after`` file bytes behave as a
  silent EOF, emulating a file that lost its tail.  Readers must raise
  `StreamFormatError`, not end the stream quietly.

`FaultSchedule.injected` counts what actually fired, so tests can assert
the fault happened (not just that the run survived).
"""
from __future__ import annotations

import dataclasses
import errno
from collections import Counter


@dataclasses.dataclass
class FaultSchedule:
    """Which call indices misbehave, and how.  Mutable shared state: one
    schedule per scenario, threaded through every file the opener hands out.
    """

    fail_opens: frozenset[int] = frozenset()
    transient_reads: frozenset[int] = frozenset()
    short_reads: frozenset[int] = frozenset()
    corrupt_reads: frozenset[int] = frozenset()
    truncate_after: int | None = None
    corrupt_byte: int = 0        # offset within the chunk to flip
    errno_code: int = errno.EIO

    def __post_init__(self) -> None:
        self.fail_opens = frozenset(self.fail_opens)
        self.transient_reads = frozenset(self.transient_reads)
        self.short_reads = frozenset(self.short_reads)
        self.corrupt_reads = frozenset(self.corrupt_reads)
        self.open_calls = 0
        self.read_calls = 0
        self.injected: Counter[str] = Counter()


class FaultyFile:
    """Binary-read file wrapper that injects the schedule's faults."""

    def __init__(self, f, schedule: FaultSchedule):
        self._f = f
        self._s = schedule

    def read(self, k: int = -1) -> bytes:
        s = self._s
        idx = s.read_calls
        s.read_calls += 1
        if idx in s.transient_reads:
            s.injected["transient_read"] += 1
            raise OSError(s.errno_code, f"injected transient error (read #{idx})")
        pos = self._f.tell()
        if s.truncate_after is not None:
            if pos >= s.truncate_after:
                s.injected["truncated_read"] += 1
                return b""
            if k is None or k < 0:
                k = s.truncate_after - pos
            else:
                k = min(k, s.truncate_after - pos)
        data = self._f.read(k)
        if idx in s.short_reads and len(data) > 1:
            s.injected["short_read"] += 1
            keep = len(data) // 2
            self._f.seek(pos + keep)
            data = data[:keep]
        if idx in s.corrupt_reads and data:
            s.injected["corrupt_read"] += 1
            b = bytearray(data)
            at = min(s.corrupt_byte, len(b) - 1)
            b[at] ^= 0xFF
            data = bytes(b)
        return data

    # -------------------------------------------------- passthrough surface
    def tell(self) -> int:
        return self._f.tell()

    def seek(self, offset: int, whence: int = 0) -> int:
        return self._f.seek(offset, whence)

    def close(self) -> None:
        self._f.close()

    @property
    def closed(self) -> bool:
        return self._f.closed

    def __enter__(self) -> "FaultyFile":
        return self

    def __exit__(self, *exc) -> None:
        self._f.close()

    def __iter__(self):
        return iter(self._f)


class FaultyOpener:
    """`open` replacement wiring a `FaultSchedule` into every file."""

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule

    def __call__(self, path, mode: str = "rb", *args, **kwargs):
        s = self.schedule
        idx = s.open_calls
        s.open_calls += 1
        if idx in s.fail_opens:
            s.injected["failed_open"] += 1
            raise OSError(s.errno_code, f"injected transient error (open #{idx})")
        return FaultyFile(open(path, mode, *args, **kwargs), s)  # repro: noqa RPR008 -- this IS the injection opener the rule routes reads through
