"""Crash-safe checkpoint/resume for the streaming drivers (DESIGN.md §11).

A host module, numpy only: the port's own copy of the reference's
`core/checkpoint.py`.  The file format is shared — the same header, CRC
and npz + JSON tree — so each package's `load_checkpoint` reads the
other's files into an equal tree.  Resume across the packages is refused:
the port's `BuffCutConfig.to_json()` carries `ml.device` (and may name the
engine "torch"), so `check_resume` finds the configs differ.

A checkpoint is one file holding everything a driver needs to continue a
partition run bit-identically from a batch boundary: the label array,
per-block float64 loads, the priority buffer's exact contents (order,
discretized keys, stamps), the retained adjacency cache, the in-progress
batch, the partial `StreamStats`, and — crucially — the stream resume token
(`NodeStreamBase.tell`) naming the byte offset of the next unread record.
Restream passes snapshot the same way (labels, loads, `IncrementalCut`
total, pass log, pending/priority buffers).

File layout, little-endian:

    magic b"BCKP" | version u32 | payload_len u64 | crc32 u32   (20 bytes)
    payload: an .npz archive — one entry per ndarray (bit-exact float64
    round-trip) plus ``__meta__``, the JSON-encoded state tree with arrays
    replaced by references.

Writes are atomic and durable: write to ``<path>.tmp``, flush + fsync,
`os.replace` onto the final name — a crash mid-write leaves the previous
checkpoint intact, never a torn file.  Loads verify magic, version, length,
and CRC before any deserialization and raise `CheckpointError` otherwise.

The packers here are the single source of truth for how each mutable
structure round-trips:

* `BucketPQ` — live nodes per bucket in order (tombstones are dropped;
  compaction preserves live LIFO order, so extraction order is unchanged),
  plus rho.
* `VectorBuffer` — the compact active/key/stamp arrays and the stamp
  counter; dense masks and bucket occupancy are rebuilt.
* `RescoreState` — counter vectors, membership mask, CMS rows, and the
  AdjacencyCache (ids in insertion order + concatenated adjacency).

Restores are strictly in-place (``arr[:] = ...``) so aliased views — the
vectorized driver shares `VectorBuffer.in_buf` with `RescoreState.member`
zero-copy — stay shared after a resume.

`Checkpointer` is the cadence gadget the drivers hold: `maybe_save` fires
when the batch counter crosses a multiple of ``every`` and builds the
snapshot lazily, so a disabled or not-yet-due checkpoint costs one integer
compare per record.
"""
from __future__ import annotations

import io
import json
import os
import struct
import time
import zlib

import numpy as np

from repro_torch.core.buffer import _HOLE

CKPT_MAGIC = b"BCKP"
CKPT_VERSION = 1
_CKPT_HEADER = struct.Struct("<4sIQI")  # magic, version, payload_len, crc32


class CheckpointError(ValueError):
    """Unusable checkpoint: bad magic/version, truncated, CRC mismatch, or
    incompatible with the run attempting to resume from it."""


# ----------------------------------------------------------- tree <-> npz


def _encode(obj, arrays: dict):
    """State tree -> JSON-able tree; ndarrays move into `arrays` and are
    replaced by ``{"__a__": key}`` references."""
    if isinstance(obj, np.ndarray):
        key = f"a{len(arrays)}"
        arrays[key] = obj
        return {"__a__": key}
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"checkpoint dict keys must be str, got {k!r}")
            out[k] = _encode(v, arrays)
        return out
    if isinstance(obj, (list, tuple)):
        return [_encode(v, arrays) for v in obj]
    if isinstance(obj, (np.integer, np.floating, np.bool_)):
        return obj.item()
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"cannot checkpoint value of type {type(obj).__name__}")


def _decode(obj, arrays):
    if isinstance(obj, dict):
        if set(obj.keys()) == {"__a__"}:
            return np.array(arrays[obj["__a__"]])  # writable copy
        return {k: _decode(v, arrays) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v, arrays) for v in obj]
    return obj


# --------------------------------------------------------------- file IO


def save_checkpoint(path: str, state: dict) -> None:
    """Atomically persist a state tree: temp file + fsync + rename, with a
    versioned header and CRC32 over the payload."""
    arrays: dict[str, np.ndarray] = {}
    meta = _encode(state, arrays)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8
    )
    bio = io.BytesIO()
    np.savez(bio, **arrays)
    payload = bio.getvalue()
    header = _CKPT_HEADER.pack(CKPT_MAGIC, CKPT_VERSION, len(payload), zlib.crc32(payload))
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(header)
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict:
    """Read + verify a checkpoint; every integrity failure is a loud
    `CheckpointError`, never a silently wrong state."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < _CKPT_HEADER.size:
        raise CheckpointError(f"{path}: truncated checkpoint header")
    magic, version, plen, crc = _CKPT_HEADER.unpack_from(raw)
    if magic != CKPT_MAGIC:
        raise CheckpointError(f"{path}: bad magic {magic!r} (not a checkpoint)")
    if version != CKPT_VERSION:
        raise CheckpointError(f"{path}: unsupported checkpoint version {version}")
    payload = raw[_CKPT_HEADER.size:]
    if len(payload) != plen:
        raise CheckpointError(
            f"{path}: truncated checkpoint payload ({len(payload)} of {plen} bytes)"
        )
    if zlib.crc32(payload) != crc:
        raise CheckpointError(
            f"{path}: checkpoint CRC mismatch (stored {crc:#010x}, computed "
            f"{zlib.crc32(payload):#010x}): file is corrupted"
        )
    with np.load(io.BytesIO(payload), allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    meta = json.loads(arrays.pop("__meta__").tobytes().decode())
    return _decode(meta, arrays)


def check_resume(resume: dict, kind: str, config_json: str, n: int) -> None:
    """Refuse to resume into a run whose shape differs from the one that
    wrote the checkpoint — a mismatch would produce silently wrong labels."""
    if resume.get("kind") != kind:
        raise CheckpointError(
            f"checkpoint was written by a {resume.get('kind')!r} run, cannot "
            f"resume a {kind!r} run from it"
        )
    if resume.get("config_json") != config_json:
        raise CheckpointError(
            "checkpoint config does not match the resuming run's config: "
            f"saved {resume.get('config_json')}, resuming {config_json}"
        )
    if int(resume.get("n", -1)) != n:
        raise CheckpointError(
            f"checkpoint covers a {resume.get('n')}-node stream, the resuming "
            f"stream has {n} nodes"
        )


def restore_run(resume: dict, kind: str, config_json: str, n: int, block: np.ndarray,
                loads: np.ndarray, st, ckpt, stats_from_dict):
    """What the three BuffCut drivers restore alike from a loaded snapshot:
    check it, fill `block`, `loads` and the rescore state `st` in place, and
    mark `ckpt` at the snapshot's batch count.  Returns the snapshot's stats
    through `stats_from_dict`; the driver restores its pending batch and its
    buffer itself."""
    check_resume(resume, kind, config_json, n)
    block[:] = resume["block"]
    loads[:] = resume["loads"]
    stats = stats_from_dict(resume["stats"])
    unpack_rescore(st, resume["state"])
    if ckpt is not None:
        ckpt.mark(stats.n_batches)
    return stats


class ResumeBase:
    """The run-long counters a driver run starts from — the snapshot's on a
    resume, zero on a fresh run — and the clock of this process's share."""

    def __init__(self, stats):
        self.runtime_s = stats.runtime_s
        self.stream_bytes_read = stats.stream_bytes_read
        self.io_retries = stats.io_retries
        self.t3_wait_s = stats.t3_wait_s
        self.t0 = time.perf_counter()

    def totals(self, stats, stream, ckpt, waited: float = 0.0, saving: bool = False) -> dict:
        """The run's counters so far: the base plus this process's reads,
        retries, T3 waits (`waited`) and checkpoint writes, the one being
        written counted when `saving`."""
        written = ckpt.written + int(saving) if ckpt is not None else 0
        return {
            "runtime_s": self.runtime_s + (time.perf_counter() - self.t0),
            "stream_bytes_read": self.stream_bytes_read + stream.bytes_read,
            "io_retries": self.io_retries + stream.io_retries,
            "t3_wait_s": self.t3_wait_s + waited,
            "checkpoints_written": stats.checkpoints_written + written,
        }

    def snapshot_stats(self, stats, stream, ckpt, waited: float = 0.0) -> dict:
        """`stats` as a snapshot being written records them."""
        return {**stats.to_dict(), **self.totals(stats, stream, ckpt, waited, saving=True)}

    def fold(self, stats, stream, ckpt, waited: float = 0.0) -> None:
        """Write the run's final counters into `stats`."""
        for key, value in self.totals(stats, stream, ckpt, waited).items():
            setattr(stats, key, value)


# --------------------------------------------------------------- packers


def pack_adjacency(adj) -> dict:
    """Snapshot an AdjacencyCache in insertion order (the order `put` saw
    the stream), so a rebuilt cache slices identically."""
    ids = np.fromiter(adj._nbr.keys(), dtype=np.int64, count=len(adj._nbr))
    nbr_list = [adj._nbr[int(v)] for v in ids]
    w_list = [adj._w[int(v)] for v in ids]
    return {
        "ids": ids,
        "degs": np.array([b.shape[0] for b in nbr_list], dtype=np.int64),
        "nbr": (np.concatenate(nbr_list) if nbr_list
                else np.empty(0, dtype=np.int64)),
        "w": (np.concatenate(w_list) if w_list
              else np.empty(0, dtype=np.float64)),
        "node_w": np.array([adj._node_w[int(v)] for v in ids], dtype=np.float64),
    }


def unpack_adjacency(adj, a: dict) -> None:
    adj._nbr.clear()
    adj._w.clear()
    adj._node_w.clear()
    adj.resident_bytes = 0
    off = 0
    for v, deg, nw in zip(a["ids"].tolist(), a["degs"].tolist(), a["node_w"].tolist()):
        adj.put(v, a["nbr"][off:off + deg], a["w"][off:off + deg], nw)
        off += deg


def pack_rescore(st) -> dict:
    """Snapshot a RescoreState (core/rescore.py): counters, membership, CMS
    rows, and the retained AdjacencyCache in insertion order."""
    out = {
        "assigned_w": st.assigned_w,
        "deg_w": st.deg_w,
        "buffered_w": st.buffered_w,
        "cmax": st.cmax,
        "member": st.member,
        "adj": pack_adjacency(st.adj),
    }
    if st.blk_w is not None:
        keys = np.fromiter(st.blk_w.keys(), dtype=np.int64, count=len(st.blk_w))
        rows = (np.stack([st.blk_w[int(u)] for u in keys])
                if keys.size else np.empty((0, st.k), dtype=np.float64))
        out["blk"] = {"keys": keys, "rows": rows}
    else:
        out["blk"] = None
    return out


def unpack_rescore(st, d: dict) -> None:
    """Restore into a freshly-constructed RescoreState of the same shape —
    strictly in place, preserving any aliasing of `member`."""
    st.assigned_w[:] = d["assigned_w"]
    st.deg_w[:] = d["deg_w"]
    if st.buffered_w is not None:
        st.buffered_w[:] = d["buffered_w"]
    if st.cmax is not None:
        st.cmax[:] = d["cmax"]
    st.member[:] = d["member"]
    if st.blk_w is not None:
        st.blk_w.clear()
        blk = d["blk"]
        for u, row in zip(blk["keys"].tolist(), blk["rows"]):
            st.blk_w[int(u)] = np.array(row, dtype=np.float64)
    unpack_adjacency(st.adj, d["adj"])


def pack_bucket_pq(pq) -> dict:
    """Live nodes per bucket, in within-bucket order.  Tombstones are not
    persisted: compaction preserves live LIFO order, so a structurally
    rebuilt PQ extracts in exactly the same sequence."""
    lens = np.empty(pq.n_buckets, dtype=np.int64)
    chunks = []
    for b, bucket in enumerate(pq.buckets):
        live = [v for v in bucket if v != _HOLE]
        lens[b] = len(live)
        chunks.append(np.asarray(live, dtype=np.int64))
    return {
        "nodes": (np.concatenate(chunks) if pq.n_buckets
                  else np.empty(0, dtype=np.int64)),
        "lens": lens,
        "rho": int(pq.rho),
    }


def unpack_bucket_pq(pq, d: dict) -> None:
    off = 0
    nodes = d["nodes"]
    size = 0
    for b, ln in enumerate(d["lens"].tolist()):
        bucket = nodes[off:off + ln].tolist()
        off += ln
        pq.buckets[b] = bucket
        pq._holes[b] = 0
        for p_, v in enumerate(bucket):
            pq.loc[v] = (b, p_)
        size += ln
    pq._size = size
    pq.rho = int(d["rho"])


def pack_vector_buffer(buf) -> dict:
    """Compact live arrays + stamp counter; the dense masks and bucket
    occupancy are derived state and rebuilt on restore."""
    size = buf._size
    return {
        "active": buf._active[:size].copy(),
        "akey": buf._akey[:size].copy(),
        "astamp": buf._astamp[:size].copy(),
        "next_stamp": int(buf._next_stamp),
        "rho": int(buf._rho),
    }


def unpack_vector_buffer(buf, d: dict) -> None:
    active = np.asarray(d["active"], dtype=np.int64)
    akey = np.asarray(d["akey"], dtype=np.int64)
    astamp = np.asarray(d["astamp"], dtype=np.int64)
    size = active.shape[0]
    buf.in_buf[:] = False
    buf.key[:] = 0
    buf.stamp[:] = 0
    buf.in_buf[active] = True
    buf.key[active] = akey
    buf.stamp[active] = astamp
    buf._active[:size] = active
    buf._akey[:size] = akey
    buf._astamp[:size] = astamp
    buf._pos[:] = -1
    buf._pos[active] = np.arange(size, dtype=np.int64)
    buf._bucket_count[:] = np.bincount(
        akey, minlength=buf.n_buckets
    ) if size else 0
    buf._next_stamp = int(d["next_stamp"])
    buf._rho = int(d["rho"])
    buf._size = size


# --------------------------------------------------------------- cadence


class Checkpointer:
    """Cadence + destination a driver holds: fire `maybe_save` with the
    current batch counter and a zero-arg state builder; the snapshot is
    built only when the counter crosses a new multiple of `every`.

    Crossing (``n // every`` advanced past the last saved counter), not
    equality: a single stream record can flush several batches back to back
    — pipelined batches commit on a worker thread — so the counter may never
    sit exactly on a multiple when the driver checks.

    `extra` is merged into every snapshot: a caller's envelope (driver
    config, source path, driver-phase stats), so that the run can be
    rebuilt from the file alone.
    """

    def __init__(self, path: str, every: int):
        if every < 0:
            raise ValueError(f"checkpoint_every must be >= 0, got {every}")
        self.path = path
        self.every = int(every)
        self.written = 0
        self._last = 0
        self.extra: dict = {}

    def due(self, n_batches: int) -> bool:
        return self.every > 0 and (n_batches // self.every) > (self._last // self.every)

    def mark(self, n_batches: int) -> None:
        """Resume bookkeeping: the restored counter already has a checkpoint
        behind it — don't immediately re-save at the first record."""
        self._last = max(self._last, int(n_batches))

    def reset(self) -> None:
        """New phase (driver -> restream): counters restart from zero."""
        self._last = 0

    def maybe_save(self, n_batches: int, make_state) -> bool:
        if not self.due(n_batches):
            return False
        state = make_state()
        if self.extra:
            state = {**state, **self.extra}
        save_checkpoint(self.path, state)
        self.written += 1
        self._last = n_batches
        return True
