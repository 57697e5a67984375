"""The device trace of one traced job: `torch.profiler` with CPU and CUDA
activity around the job, written as a Chrome trace and reduced to

- `window_s`: the length of the job's own span (`job`);
- `busy_s`: the union of the device's kernels, copies and sets inside it;
- `rows`: device seconds and launch counts by operation name;
- `gaps`: the idle time between device operations, summed by what the
  host was doing then: the innermost benchmark span (`batch_model`,
  `vcycle`, a kernel wrapper, else `driver`) and the host op that holds
  the middle of each stretch of idle time within one span.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
JOB = "job"


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    rows: dict        # name -> [device seconds, launches]
    gaps: dict        # what the host did -> idle seconds


@contextlib.contextmanager
def profiled(path: Path, done: list):
    """Profile the block as the span `job`, then write its Chrome trace to
    `path`; `done` gets the host clock at the block's end, before the
    profiler stops (its start, which loads the tracer, is before the
    block's)."""
    import time

    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(JOB):
            yield
        done.append(time.perf_counter())
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))


def merged(intervals: list) -> list:
    """Sorted, disjoint union of (start, end) intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def innermost(events: list, points: list) -> list:
    """For each time in `points` (ascending), the name of the innermost
    event of `events` ((start, end, name), properly nested) that holds it,
    or None."""
    events = sorted(events, key=lambda e: (e[0], -e[1]))
    out, stack, i = [], [], 0
    for p in points:
        while i < len(events) and events[i][0] <= p:
            while stack and stack[-1][1] <= events[i][0]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] <= p:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def reduce_events(events: list, span_names) -> Trace:
    """Reduce the Chrome trace's events (times in microseconds)."""
    job = [e for e in events if e.get("name") == JOB and e.get("cat") == "user_annotation"]
    if not job:
        raise ValueError("the trace holds no job span")
    j0 = float(job[0]["ts"])
    j1 = j0 + float(job[0]["dur"])
    tid = job[0]["tid"]
    rows: dict = {}
    dev = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            s, d = float(e["ts"]), float(e.get("dur", 0.0))
            row = rows.setdefault(e["name"], [0.0, 0])
            row[0] += d * 1e-6
            row[1] += 1
            if s < j1 and s + d > j0:
                dev.append((max(s, j0), min(s + d, j1)))
    busy = merged(dev)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    idle = []
    t = j0
    for s, e in busy:
        if s > t:
            idle.append((t, s))
        t = max(t, e)
    if t < j1:
        idle.append((t, j1))
    host = [e for e in events if e.get("ph") == "X" and e.get("tid") == tid
            and e.get("cat") in ("cpu_op", "user_annotation")]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in host if e["name"] in span_names]
    ops = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
           for e in host if e["cat"] == "cpu_op"]
    # cut the gaps where a benchmark span starts or ends, then name each
    # piece by what holds its middle
    cuts = sorted({t for s, e, _ in spans for t in (s, e)})
    pieces = []
    for s, e in idle:
        inner = cuts[bisect.bisect_right(cuts, s):bisect.bisect_left(cuts, e)]
        edges = [s, *inner, e]
        pieces += list(zip(edges[:-1], edges[1:]))
    mids = [(s + e) / 2 for s, e in pieces]
    gaps: dict = {}
    for (s, e), span, op in zip(pieces, innermost(spans, mids), innermost(ops, mids)):
        key = f"{span or 'driver'}:{op}" if op else (span or "driver")
        gaps[key] = gaps.get(key, 0.0) + (e - s) * 1e-6
    return Trace(window_s=(j1 - j0) * 1e-6, busy_s=busy_s, rows=rows, gaps=gaps)


def read_trace(path: Path, span_names) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.unlink(path)
    return reduce_events(events, set(span_names))


def top(d: dict, n: int = 10) -> list:
    """The `n` largest entries of {name: seconds or [seconds, count]}."""
    items = [(k, v[0] if isinstance(v, list) else v) for k, v in d.items()]
    return [[k, v] for k, v in sorted(items, key=lambda kv: -kv[1])[:n]]
