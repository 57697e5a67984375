"""Scripted serving workloads: delta files, churn generators, timed replay.

A workload is a list of ``(verb, payload)`` ops — exactly the three service
verbs — produced either by parsing a *delta file* or by the seeded *churn
generator*, and executed by `run_workload` with per-verb latency capture.
Verification (the lookup checksum) happens strictly *outside* the timed
region, so reported latencies measure the serving path, not the check.

Delta file format (one op per line, ``#`` comments and blanks skipped)::

    add u v [w]      # insert edge (alias: + u v [w]); w defaults to 1
    del u v          # delete edge (alias: - u v)
    node [w]         # add one node (weight defaults to 1)
    lookup u1 u2 ... # gather labels (alias: ? u1 u2 ...)
    refine [budget]  # drain the priority buffer (alias: ! [budget])

Consecutive mutation lines (add/del/node) are grouped into one ``update``
request — the file's batching is explicit in its lookup/refine line
placement.  Parse errors are loud and carry the 1-based line number.

The churn generator (`ChurnSpec` / `churn_ops`) fabricates a mixed
insert/delete/node-add stream against a *mirror* of the current edge set,
so every generated delete targets an existing edge and every insert a
fresh pair — deterministic under its seed, replayable, and safe to apply
twice (the service-determinism test does exactly that).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.graphs.csr import CSRGraph

_MUTATION_OPS = {"add", "+", "del", "-", "node"}


@dataclasses.dataclass
class ChurnSpec:
    """Parameters of the generated churn workload.

    Spec strings look like ``churn:updates=64,ops=16,frac_del=0.25,seed=0``
    (any field below; unknown fields are loud errors).
    """

    updates: int = 64          # number of update requests
    ops: int = 16              # edge ops per update request
    frac_del: float = 0.25     # probability an op is a deletion
    node_adds: int = 0         # total new nodes, one per update from the start
    lookup_every: int = 4      # a lookup after every Nth update (0 = never)
    lookup_size: int = 256     # nodes per lookup request
    refine_every: int = 8      # a refine after every Nth update (0 = never)
    refine_budget: "int | None" = None  # None = drain the whole buffer
    seed: int = 0

    def __post_init__(self) -> None:
        if self.updates < 0 or self.ops < 1:
            raise ValueError(
                f"churn needs updates >= 0 and ops >= 1, got "
                f"updates={self.updates} ops={self.ops}")
        if not 0.0 <= self.frac_del <= 1.0:
            raise ValueError(f"frac_del must be in [0, 1], got {self.frac_del}")

    @classmethod
    def parse(cls, spec: str) -> "ChurnSpec":
        body = spec
        for prefix in ("gen:", "churn:"):
            if body.startswith(prefix):
                body = body[len(prefix):]
        kwargs: dict = {}
        if body:
            fields = {f.name: f for f in dataclasses.fields(cls)}
            for item in body.split(","):
                if not item:
                    continue
                if "=" not in item:
                    raise ValueError(
                        f"bad churn spec item {item!r} in {spec!r}: expected "
                        "key=value")
                key, val = item.split("=", 1)
                key = key.strip()
                if key not in fields:
                    raise ValueError(
                        f"unknown churn spec field {key!r} in {spec!r}: "
                        f"known fields are {sorted(fields)}")
                if key == "refine_budget" and val.strip().lower() == "none":
                    kwargs[key] = None
                elif key == "frac_del":
                    kwargs[key] = float(val)
                else:
                    kwargs[key] = int(val)
        return cls(**kwargs)


def churn_ops(g: CSRGraph, spec: ChurnSpec) -> list:
    """Generate the scripted op list for `spec` against graph `g`'s
    current edge set.  Deterministic under ``spec.seed``."""
    rng = np.random.default_rng(spec.seed)
    mirror = [(int(u), int(v)) for u, v in g.to_edge_list()]
    eset = set(mirror)
    n_live = g.n
    nodes_left = spec.node_adds
    ops: list = []
    for bi in range(spec.updates):
        inserts: list = []
        deletes: list = []
        batch_deleted: set = set()
        add_nodes = 0
        if nodes_left > 0:
            add_nodes = 1
            nodes_left -= 1
            new_id = n_live
            n_live += 1
            # attach the new node immediately so node adds exercise more
            # than the empty-adjacency Fennel placement
            v = int(rng.integers(n_live - 1))
            inserts.append((new_id, v, 1.0))
            eset.add((v, new_id))
            mirror.append((v, new_id))
        for _ in range(spec.ops):
            do_del = bool(rng.random() < spec.frac_del) and bool(mirror)
            if not do_del:
                e = None
                for _try in range(64):
                    u = int(rng.integers(n_live))
                    v = int(rng.integers(n_live))
                    if u == v:
                        continue
                    cand = (min(u, v), max(u, v))
                    # re-inserting an edge deleted earlier in this batch
                    # would be un-deleted by the service's insert-before-
                    # delete batch order — skip those pairs
                    if cand in eset or cand in batch_deleted:
                        continue
                    e = cand
                    break
                if e is None:
                    do_del = bool(mirror)
                    if not do_del:
                        continue
                else:
                    inserts.append((e[0], e[1], 1.0))
                    eset.add(e)
                    mirror.append(e)
            if do_del:
                j = int(rng.integers(len(mirror)))
                e = mirror[j]
                mirror[j] = mirror[-1]
                mirror.pop()
                eset.discard(e)
                batch_deleted.add(e)
                deletes.append(e)
        ops.append(("update", {
            "add_nodes": add_nodes if add_nodes else None,
            "insert_edges": inserts if inserts else None,
            "delete_edges": deletes if deletes else None,
        }))
        if spec.lookup_every and (bi + 1) % spec.lookup_every == 0:
            ops.append(("lookup",
                        rng.integers(n_live, size=spec.lookup_size)
                        .astype(np.int64)))
        if spec.refine_every and (bi + 1) % spec.refine_every == 0:
            ops.append(("refine", spec.refine_budget))
    if spec.refine_every:
        ops.append(("refine", spec.refine_budget))
    return ops


def _parse_error(path: str, lineno: int, line: str, why: str) -> ValueError:
    return ValueError(f"{path}:{lineno}: bad delta line {line!r}: {why}")


def load_delta_file(path: str) -> list:
    """Parse a delta file (module docstring has the grammar) into the
    ``(verb, payload)`` op list `run_workload` consumes."""
    ops: list = []
    pending: "dict | None" = None

    def flush() -> None:
        nonlocal pending
        if pending is not None:
            ops.append(("update", pending))
            pending = None

    def mutation() -> dict:
        nonlocal pending
        if pending is None:
            pending = {"add_nodes": None, "insert_edges": None,
                       "delete_edges": None}
        return pending

    with open(path, "r", encoding="utf-8") as fh:
        for lineno, raw in enumerate(fh, start=1):
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            op, args = parts[0].lower(), parts[1:]
            try:
                if op in ("add", "+"):
                    if len(args) not in (2, 3):
                        raise ValueError("expected: add u v [w]")
                    u, v = int(args[0]), int(args[1])
                    w = float(args[2]) if len(args) == 3 else 1.0
                    p = mutation()
                    p["insert_edges"] = (p["insert_edges"] or [])
                    p["insert_edges"].append((u, v, w))
                elif op in ("del", "-"):
                    if len(args) != 2:
                        raise ValueError("expected: del u v")
                    p = mutation()
                    p["delete_edges"] = (p["delete_edges"] or [])
                    p["delete_edges"].append((int(args[0]), int(args[1])))
                elif op == "node":
                    if len(args) > 1:
                        raise ValueError("expected: node [w]")
                    w = float(args[0]) if args else 1.0
                    p = mutation()
                    p["add_nodes"] = (p["add_nodes"] or [])
                    p["add_nodes"].append(w)
                elif op in ("lookup", "?"):
                    if not args:
                        raise ValueError("expected: lookup u1 [u2 ...]")
                    flush()
                    ops.append(("lookup",
                                np.asarray([int(a) for a in args],
                                           dtype=np.int64)))
                elif op in ("refine", "!"):
                    if len(args) > 1:
                        raise ValueError("expected: refine [budget]")
                    flush()
                    ops.append(("refine", int(args[0]) if args else None))
                else:
                    raise ValueError(
                        f"unknown op {op!r} (know: add/+ del/- node lookup/? "
                        "refine/!)")
            except ValueError as e:
                raise _parse_error(path, lineno, line, str(e)) from None
    flush()
    return ops


def _lat_summary(samples: "list[float]") -> dict:
    if not samples:
        return {"count": 0, "total_s": 0.0, "mean_ms": 0.0,
                "p50_ms": 0.0, "p99_ms": 0.0}
    arr = np.asarray(samples, dtype=np.float64)
    return {
        "count": int(arr.size),
        "total_s": float(arr.sum()),
        "mean_ms": float(arr.mean() * 1e3),
        "p50_ms": float(np.percentile(arr, 50) * 1e3),
        "p99_ms": float(np.percentile(arr, 99) * 1e3),
    }


def run_workload(target, ops) -> dict:
    """Replay `ops` against `target` (a `PartitionService` or a
    `ServeSession`) and return per-verb latency summaries plus sustained
    rates.  Only the verb call is timed; checksum verification and
    bookkeeping happen between timed regions."""
    lat: dict = {"lookup": [], "update": [], "refine": []}
    edge_ops = 0
    lookup_nodes = 0
    checksum = 0
    for kind, payload in ops:
        if kind == "lookup":
            t0 = time.perf_counter()
            out = target.lookup(payload)
            lat["lookup"].append(time.perf_counter() - t0)
            lookup_nodes += int(np.asarray(payload).size)
            checksum += int(np.asarray(out, dtype=np.int64).sum())
        elif kind == "update":
            t0 = time.perf_counter()
            out = target.update(**payload)
            lat["update"].append(time.perf_counter() - t0)
            edge_ops += (out["edge_inserts"] + out["edge_deletes"]
                         + len(out["nodes_added"]))
        elif kind == "refine":
            t0 = time.perf_counter()
            target.refine(payload)
            lat["refine"].append(time.perf_counter() - t0)
        else:
            raise ValueError(
                f"unknown workload verb {kind!r} (know: lookup/update/refine)")
    out = {verb: _lat_summary(ts) for verb, ts in lat.items()}
    upd_s = out["update"]["total_s"]
    lkp_s = out["lookup"]["total_s"]
    out["update"]["edge_ops"] = edge_ops
    out["update"]["updates_per_s"] = (edge_ops / upd_s) if upd_s > 0 else 0.0
    out["lookup"]["nodes"] = lookup_nodes
    out["lookup"]["lookups_per_s"] = (lookup_nodes / lkp_s) if lkp_s > 0 else 0.0
    out["lookup_checksum"] = checksum
    return out
