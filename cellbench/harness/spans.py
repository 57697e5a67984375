"""The benchmark's own spans around the program's calls, installed by
wrapping the functions that a traffic mix names where its driver binds
them.

`spans` (every run) names the driver's module and, under the roles
`batch_model` and `vcycle`, the functions it calls to build a batch's
model and to label it.  A batch's time runs from the batch model's call
to the V-cycle's return; the two are paired first in, first out, so a
driver that builds on one thread and labels on another pairs right.

`kernel_spans` (traced runs only) names the module that launches the
kernels and, under each kernel's name, its wrapper there.  Each call is
a profiler range of that name and leaves a summary of its arguments
(a tensor's shape, a number's value) for the metrics to read.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import importlib
import threading
import time


class Spans:
    def __init__(self) -> None:
        self.batches: list = []           # (start, V-cycle start, end), host seconds
        self.launches: dict = {}          # kernel name -> [argument summaries]
        self.tracing = False              # inside the traced job
        self._pending: collections.deque = collections.deque()
        self._lock = threading.Lock()

    def clear(self) -> None:
        self.batches = []
        self.launches = {}
        self._pending.clear()


def summary(x):
    shape = getattr(x, "shape", None)
    if shape is not None:
        return tuple(int(d) for d in shape)
    if isinstance(x, (bool, int, float)):
        return x
    return None


def _range(spans: Spans, name: str):
    if not spans.tracing:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


def _batch_model(spans: Spans, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        with _range(spans, "batch_model"):
            out = fn(*args, **kwargs)
        spans._pending.append(t0)
        return out
    return wrapper


def _vcycle(spans: Spans, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t1 = time.perf_counter()
        with _range(spans, "vcycle"):
            out = fn(*args, **kwargs)
        t2 = time.perf_counter()
        t0 = spans._pending.popleft() if spans._pending else t1
        with spans._lock:
            spans.batches.append((t0, t1, t2))
        return out
    return wrapper


def _kernel(spans: Spans, name: str, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not spans.tracing:
            return fn(*args, **kwargs)
        args_s = [summary(a) for a in args]
        kwargs_s = {k: summary(v) for k, v in kwargs.items()}
        with spans._lock:
            spans.launches.setdefault(name, []).append((args_s, kwargs_s))
        with _range(spans, name):
            return fn(*args, **kwargs)
    return wrapper


def install(traffic: dict, spans: Spans, *, kernels: bool):
    """Wrap the functions the traffic mix names; returns the undo."""
    patched = []

    def patch(module_name: str, attr: str, wrapper) -> None:
        mod = importlib.import_module(module_name)
        orig = getattr(mod, attr)
        patched.append((mod, attr, orig))
        setattr(mod, attr, wrapper(orig))

    roles = traffic["spans"]
    patch(roles["module"], roles["batch_model"], functools.partial(_batch_model, spans))
    patch(roles["module"], roles["vcycle"], functools.partial(_vcycle, spans))
    if kernels:
        ks = traffic["kernel_spans"]
        for name, attr in ks["functions"].items():
            patch(ks["module"], attr, functools.partial(_kernel, spans, name))

    def undo() -> None:
        for mod, attr, orig in reversed(patched):
            setattr(mod, attr, orig)
    return undo


def span_names(traffic: dict) -> list:
    return ["batch_model", "vcycle", *traffic["kernel_spans"]["functions"]]
