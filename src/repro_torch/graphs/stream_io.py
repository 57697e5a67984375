"""Out-of-core stream substrate: chunked disk readers + packed format.

A host module, numpy only, and the port's own copy of the reference's
`graphs/stream_io.py`: the files it writes are byte-identical to the
reference's, so a file moves between the two packages either way.

This module is what makes the §4 memory accounting real instead of modeled:
graphs are parsed incrementally from disk — METIS text or the packed binary
format below — behind the `NodeStreamBase` protocol, holding only a bounded
read-ahead window (one IO chunk + the record spanning its edge).  The full
CSR is never materialized, so the partitioner's peak resident set is
buffer + batch + read-ahead, and graphs larger than RAM stream fine.

Packed binary format (``.bcsr``), little-endian — the byte-level
specification (header offsets, v2 header CRC at pad offset 44, rolling
section CRCs, legacy-v1 semantics) is docs/FORMATS.md; summary:

    magic  b"BCSR" | version u32 | flags u32 (1 = edge weights,
    2 = node weights) | n u64 | m u64 (undirected edges) |
    n_total f64 | m_total f64 | 20 pad bytes          (64-byte header)

Version 1 body: n records back to back.  Version 2 (the default since the
fault-tolerance PR, DESIGN.md §11) groups records into *sections*, each
prefixed by ``payload_len u32 | crc32 u32``; a section closes every
`SECTION_RECORDS` records or `SECTION_BYTES` payload bytes, whichever comes
first, and records never span sections.  Each record is
``deg u32 [node_w f32] nbr u32[deg] [w f32[deg]]`` in both versions.

The reader verifies each section's CRC *as it streams* (rolling crc32 over
consumed payload bytes — residency stays one IO chunk, not one section) and
raises `StreamFormatError` at the section boundary on any mismatch, so a
bit-flipped or truncated file can never complete into a wrong partition.
Version-1 files remain readable but are flagged unverified
(`DiskNodeStream.crc_protected` is False).  Truncation anywhere — header,
section header, or mid-record — is a loud `StreamFormatError`, never a
silent EOF.

Transient IO errors (`OSError` other than not-found/permission/is-a-dir)
are retried with bounded exponential backoff (`RetryPolicy`); retries are
counted on the reader (`io_retries`) and surfaced through
`StreamStats.io_retries`.  `opener` injects an alternative `open` — the
fault-injection harness (graphs/faults.py) plugs in here.

Resumable iteration (checkpoint/resume, core/checkpoint.py): both readers
track the byte position of the next record as they go; `DiskNodeStream.tell`
returns a JSON-able token — next record ``index``, seek ``offset`` (a
section start for v2 packed files), records to ``skip`` after the seek, and
the running ``directed`` entry count — and `iter_from(token)` resumes the
stream bit-identically to the tail of a full read.  Because v2 resume
always seeks to a *section start* and re-accumulates that section's CRC
over skipped records too, corruption inside a partially-consumed section is
re-detected on resume.

The header carries the canonical totals (graphs/stream.py) so weighted
graphs need no pre-pass; METIS text streams derive them from the header for
fmt 00 and pay one counting pre-pass for weighted formats (HeiStream's
reference reader does the same).

`permute_to_disk` realizes stream orderings (BFS / KONECT / adversarial)
without an in-memory graph: records are relabeled, re-sorted *within* each
row into the canonical order `CSRGraph.from_edges` produces (neighbors > v
ascending, then < v ascending), bucketed into on-disk shards by destination
id range, and each shard — bounded by `shard_nodes` — is ordered and
appended to the output.  The result is byte-for-byte the stream
`apply_order` would produce from memory, which the conformance suite pins.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import time
import zlib

import numpy as np

from repro_torch.graphs.csr import CSRGraph
from repro_torch.graphs.stream import (
    NodeStreamBase,
    as_node_stream,
    canonical_totals,
    seq_sum64,
)

MAGIC = b"BCSR"
_HEADER = struct.Struct("<4sIIQQdd20x")  # 64 bytes
_U32 = struct.Struct("<I")
_F32 = struct.Struct("<f")

# shared unit-weight pool for weightless records: readers yield read-only
# slices instead of allocating np.ones per record (~2us each on the parse
# hot path).  Consumers copy on cast (AdjacencyCache, ELL builders), and the
# write=False flag turns any accidental in-place mutation into an error.
_UNIT_W = np.ones(0, dtype=np.float32)


def _unit_weights(deg: int) -> np.ndarray:
    global _UNIT_W
    if deg > _UNIT_W.shape[0]:
        w = np.ones(max(deg, 4096), dtype=np.float32)
        w.setflags(write=False)
        _UNIT_W = w
    return _UNIT_W[:deg]
_HDR_CRC_OFF = _HEADER.size - 20         # v2: crc32 of bytes [0,44) in pad
_SECTION = struct.Struct("<II")          # payload_len, crc32
_FLAG_EDGE_W = 1
_FLAG_NODE_W = 2
DEFAULT_IO_CHUNK = 1 << 20
PACKED_VERSION = 2
SECTION_RECORDS = 1 << 12   # close a section every 4096 records ...
SECTION_BYTES = 1 << 20     # ... or 1 MiB of payload, whichever first


class StreamFormatError(ValueError):
    """Malformed graph file (bad header, truncated data, invalid record,
    CRC mismatch)."""


# ------------------------------------------------------------ IO hardening


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry-with-backoff for transient IO errors.

    `retries` is the number of re-attempts after the first failure; the
    sleep starts at `backoff_s` and doubles per attempt.  Not-found /
    permission / is-a-directory errors are never transient and propagate
    immediately.  `retries=0` disables retrying.
    """

    retries: int = 3
    backoff_s: float = 0.01

    def is_transient(self, e: OSError) -> bool:
        return not isinstance(
            e, (FileNotFoundError, PermissionError, IsADirectoryError, NotADirectoryError)
        )


DEFAULT_RETRY = RetryPolicy()


def _retrying(fn, policy: "RetryPolicy | None", counter=None):
    """Call `fn()`; on a transient OSError retry up to `policy.retries`
    times with exponential backoff, bumping `counter` (a 1-element list)
    per retry.  The final failure propagates."""
    if policy is None or policy.retries <= 0:
        return fn()
    delay = policy.backoff_s
    for attempt in range(policy.retries + 1):
        try:
            return fn()
        except OSError as e:
            if not policy.is_transient(e) or attempt == policy.retries:
                raise
            if counter is not None:
                counter[0] += 1
            time.sleep(delay)
            delay *= 2.0


def _read_retrying(f, k: int, policy: "RetryPolicy | None", counter=None) -> bytes:
    """`f.read(k)` with transient-error retry; the file position is pinned
    before each attempt so a failed partial read cannot skip bytes."""
    pos = f.tell()

    def attempt() -> bytes:
        if f.tell() != pos:
            f.seek(pos)
        return f.read(k)

    return _retrying(attempt, policy, counter)


def _read_exact(f, k: int) -> bytes:
    """Read exactly `k` bytes unless EOF intervenes: POSIX read() may
    legitimately return fewer bytes than asked, so fixed-size probes (magic,
    packed header) must loop or they misparse on a partial read."""
    buf = b""
    while len(buf) < k:
        chunk = f.read(k - len(buf))
        if not chunk:
            break
        buf += chunk
    return buf


# --------------------------------------------------------------- METIS text


def _parse_metis_header(line: bytes, path: str) -> tuple[int, int, bool, bool]:
    toks = line.split()
    if len(toks) < 2 or len(toks) > 3:
        raise StreamFormatError(
            f"{path}: METIS header must be 'n m [fmt]', got {line.decode(errors='replace')!r}"
        )
    try:
        n, m = int(toks[0]), int(toks[1])
    except ValueError:
        raise StreamFormatError(f"{path}: non-integer METIS header fields {toks[:2]}") from None
    if n < 0 or m < 0:
        raise StreamFormatError(f"{path}: negative n or m in METIS header (n={n}, m={m})")
    fmt = toks[2].decode() if len(toks) > 2 else "00"
    fmt = fmt.zfill(2)
    if fmt not in ("00", "01", "10", "11"):
        raise StreamFormatError(
            f"{path}: unsupported METIS fmt {fmt!r} (supported: 00, 01/1, 10, 11)"
        )
    return n, m, fmt[0] == "1", fmt[1] == "1"


class MetisChunkReader:
    """Incremental METIS text parser: fixed-size byte chunks in, one node
    record out at a time, independent of where chunk boundaries fall.

    Tolerates trailing whitespace, CR line endings, '%' comment lines and
    blank lines (isolated nodes, unless node weights make them malformed).
    Raises StreamFormatError with the offending node on any malformed data.
    Transient read errors retry per `retry`; `opener` swaps the `open`
    implementation (fault injection).  `next_pos` is the resume token for
    the record after the last one yielded (see module docstring).
    """

    def __init__(self, path: str, io_chunk_bytes: int = DEFAULT_IO_CHUNK,
                 *, opener=open, retry: "RetryPolicy | None" = DEFAULT_RETRY):
        self.path = path
        self.io_chunk_bytes = max(1, int(io_chunk_bytes))
        self.opener = opener
        self.retry = retry
        self.bytes_read = 0
        self.resident_bytes = 0
        self._io_retries = [0]
        self._header: tuple[int, int, bool, bool] | None = None
        self._offset = 0  # absolute byte offset of the next unconsumed line
        self.next_pos: dict = {"index": 0, "offset": 0, "skip": 0, "directed": 0}

    @property
    def io_retries(self) -> int:
        return self._io_retries[0]

    def header(self) -> tuple[int, int, bool, bool]:
        """(n, m, has_node_w, has_edge_w) — reads just enough of the file."""
        if self._header is None:
            for _ in self._lines(count_into_self=False):
                break
            if self._header is None:
                raise StreamFormatError(f"{self.path}: empty file, missing METIS header")
        return self._header

    def _lines(self, count_into_self: bool = True, start_offset: "int | None" = None):
        """Yield data lines (header consumed internally, comments skipped).

        A trailing newline terminates the last line rather than opening a
        phantom blank one; interior blank lines are real (isolated nodes).
        `self._offset` always holds the absolute byte offset just past the
        most recently yielded (or skipped) line.  With `start_offset` the
        file is entered mid-body (resume): the header must already be known.
        """
        buf = b""
        saw_header = start_offset is not None
        self._offset = start_offset or 0

        def handle(line: bytes):
            nonlocal saw_header
            line = line.strip()
            if line.startswith(b"%"):
                return None
            if not saw_header:
                if not line:
                    return None  # leading blank lines before the header
                self._header = _parse_metis_header(line, self.path)
                saw_header = True
                return True  # header sentinel (consumed by header())
            return line

        f = _retrying(lambda: self.opener(self.path, "rb"), self.retry, self._io_retries)
        with f:
            if start_offset:
                f.seek(start_offset)
            while True:
                chunk = _read_retrying(f, self.io_chunk_bytes, self.retry, self._io_retries)
                if not chunk:
                    if buf:  # final line without trailing newline
                        out = handle(buf)
                        self._offset += len(buf)
                        if out is True:
                            yield None
                        elif out is not None:
                            yield out
                    if count_into_self:
                        self.resident_bytes = 0
                    return
                if count_into_self:
                    self.bytes_read += len(chunk)
                buf += chunk
                if count_into_self:
                    self.resident_bytes = len(buf)
                parts = buf.split(b"\n")
                buf = parts.pop()
                for line in parts:
                    out = handle(line)
                    self._offset += len(line) + 1
                    if out is True:
                        yield None
                    elif out is not None:
                        yield out

    def records(self, start: "dict | None" = None):
        """Yield (nbrs int32, weights float32, node_w float) per node, in
        file order; exactly n records or StreamFormatError.  `start` is a
        `next_pos` token: parsing resumes at that byte offset / node index
        with the directed-entry counter seeded, so the end-of-stream
        validation still holds across a resume."""
        if start is not None and int(start["offset"]) == 0:
            start = None  # offset 0 precedes the header: a fresh start
        if start is None:
            lines = self._lines()
            try:
                next(lines)  # header sentinel
            except StopIteration:
                raise StreamFormatError(
                    f"{self.path}: empty file, missing METIS header"
                ) from None
            v = 0
            directed = 0
        else:
            self.header()  # n/m/fmt come from the file head
            lines = self._lines(start_offset=int(start["offset"]))
            v = int(start["index"])
            directed = int(start["directed"])
        n, m, has_nw, has_ew = self._header
        for line in lines:
            if v >= n:
                if line:
                    raise StreamFormatError(
                        f"{self.path}: trailing data after {n} node lines"
                    )
                continue  # trailing blank lines are fine
            toks = line.split()
            i = 0
            node_w = 1.0
            if has_nw:
                if not toks:
                    raise StreamFormatError(
                        f"{self.path}: node {v + 1}: missing node weight (fmt requires one)"
                    )
                try:
                    node_w = float(toks[0])
                except ValueError:
                    raise StreamFormatError(
                        f"{self.path}: node {v + 1}: bad node weight {toks[0]!r}"
                    ) from None
                i = 1
            rest = toks[i:]
            if has_ew and len(rest) % 2:
                raise StreamFormatError(
                    f"{self.path}: node {v + 1}: odd token count with edge weights (fmt x1)"
                )
            try:
                if has_ew:
                    nbrs = np.array([int(t) for t in rest[0::2]], dtype=np.int64)
                    wts = np.array([float(t) for t in rest[1::2]], dtype=np.float32)
                else:
                    nbrs = np.array([int(t) for t in rest], dtype=np.int64)
                    wts = _unit_weights(nbrs.shape[0])
            except ValueError:
                raise StreamFormatError(
                    f"{self.path}: node {v + 1}: non-numeric adjacency token"
                ) from None
            if nbrs.size and (nbrs.min() < 1 or nbrs.max() > n):
                raise StreamFormatError(
                    f"{self.path}: node {v + 1}: neighbor id out of range [1, {n}]"
                )
            directed += int(nbrs.size)
            v += 1
            self.next_pos = {
                "index": v, "offset": self._offset, "skip": 0, "directed": directed,
            }
            yield (nbrs - 1).astype(np.int32), wts, node_w
        if v != n:
            raise StreamFormatError(
                f"{self.path}: expected {n} node lines, file ended after {v}"
            )
        if directed != 2 * m:
            raise StreamFormatError(
                f"{self.path}: header m={m} but parsed {directed} directed entries "
                f"(expected {2 * m})"
            )


# ------------------------------------------------------------ packed binary


class PackedWriter:
    """Incremental writer for the packed format — one record at a time, no
    CSR required.  Keeps O(n) totals state (deg_w, node_w) to stamp the
    canonical aggregates into the header on close.

    Version 2 (default) buffers records into CRC32-protected sections
    (`section_records` / `section_bytes` close thresholds); pass
    ``version=1`` to emit the legacy unprotected layout.
    """

    def __init__(self, path: str, n: int, m: int, *, has_edge_w: bool, has_node_w: bool,
                 version: int = PACKED_VERSION,
                 section_records: int = SECTION_RECORDS,
                 section_bytes: int = SECTION_BYTES):
        if version not in (1, 2):
            raise ValueError(f"packed version must be 1 or 2, got {version}")
        self.path = path
        self.n = int(n)
        self.m = int(m)
        self.has_edge_w = has_edge_w
        self.has_node_w = has_node_w
        self.version = int(version)
        self.section_records = max(1, int(section_records))
        self.section_bytes = max(1, int(section_bytes))
        # durable writes: build the file under a .tmp sibling; close()
        # fsyncs and os.replace()s it onto the final name, so a crash
        # mid-pack leaves the previous complete file (or nothing)
        self._tmp_path = f"{path}.tmp"
        self._f = open(self._tmp_path, "wb")
        self._f.write(_HEADER.pack(MAGIC, self.version, 0, 0, 0, 0.0, 0.0))  # placeholder
        self._deg_w = np.zeros(self.n, dtype=np.float64)
        self._node_w = np.ones(self.n, dtype=np.float32)
        self._written = 0
        self._directed = 0
        self._sec = bytearray()
        self._sec_records = 0

    def _flush_section(self) -> None:
        if not self._sec:
            return
        self._f.write(_SECTION.pack(len(self._sec), zlib.crc32(self._sec)))
        self._f.write(self._sec)
        self._sec = bytearray()
        self._sec_records = 0

    def write_node(self, nbrs: np.ndarray, weights: np.ndarray | None = None,
                   node_w: float = 1.0) -> None:
        v = self._written
        if v >= self.n:
            raise StreamFormatError(f"{self.path}: more than n={self.n} records written")
        nbrs = np.asarray(nbrs)
        if weights is None:
            weights = np.ones(nbrs.shape[0], dtype=np.float32)
        weights = np.asarray(weights, dtype=np.float32)
        rec = bytearray(struct.pack("<I", nbrs.shape[0]))
        if self.has_node_w:
            rec += struct.pack("<f", node_w)
        rec += nbrs.astype("<u4").tobytes()
        if self.has_edge_w:
            rec += weights.astype("<f4").tobytes()
        if self.version == 1:
            self._f.write(rec)
        else:
            self._sec += rec
            self._sec_records += 1
            if (self._sec_records >= self.section_records
                    or len(self._sec) >= self.section_bytes):
                self._flush_section()
        self._deg_w[v] = seq_sum64(weights)
        self._node_w[v] = node_w
        self._directed += int(nbrs.shape[0])
        self._written += 1

    def _abort(self) -> None:
        self._f.close()
        if os.path.exists(self._tmp_path):
            os.remove(self._tmp_path)

    def close(self) -> None:
        if self._written != self.n:
            self._abort()
            raise StreamFormatError(
                f"{self.path}: wrote {self._written} of {self.n} records"
            )
        if self._directed != 2 * self.m:
            self._abort()
            raise StreamFormatError(
                f"{self.path}: m={self.m} but {self._directed} directed entries written"
            )
        if self.version >= 2:
            self._flush_section()
        n_total, m_total = canonical_totals(self._deg_w, self._node_w)
        flags = (_FLAG_EDGE_W if self.has_edge_w else 0) | (_FLAG_NODE_W if self.has_node_w else 0)
        hdr = _HEADER.pack(MAGIC, self.version, flags, self.n, self.m, n_total, m_total)
        if self.version >= 2:
            # header CRC lives in the first 4 pad bytes: the section CRCs
            # cover the data, this covers n/m/totals (a flipped total would
            # silently skew every score)
            hdr = hdr[:_HDR_CRC_OFF] + struct.pack(
                "<I", zlib.crc32(hdr[:_HDR_CRC_OFF])
            ) + hdr[_HDR_CRC_OFF + 4:]
        self._f.seek(0)
        self._f.write(hdr)
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        os.replace(self._tmp_path, self.path)

    def __enter__(self) -> "PackedWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:
            self._abort()


def read_packed_header(path: str, *, opener=open,
                       retry: "RetryPolicy | None" = DEFAULT_RETRY,
                       retry_counter=None) -> dict:
    def _read() -> bytes:
        with opener(path, "rb") as f:
            return _read_exact(f, _HEADER.size)

    raw = _retrying(_read, retry, retry_counter)
    if len(raw) < _HEADER.size:
        raise StreamFormatError(f"{path}: truncated packed header")
    magic, version, flags, n, m, n_total, m_total = _HEADER.unpack(raw)
    if magic != MAGIC:
        raise StreamFormatError(f"{path}: bad magic {magic!r} (not a packed graph)")
    if version not in (1, 2):
        raise StreamFormatError(f"{path}: unsupported packed version {version}")
    if version >= 2:
        # stored 0 = legacy v2 file from before the header CRC: readable,
        # just unverified (mirrors the v1 "no CRC" contract)
        stored = struct.unpack_from("<I", raw, _HDR_CRC_OFF)[0]
        computed = zlib.crc32(raw[:_HDR_CRC_OFF])
        if stored != 0 and stored != computed:
            raise StreamFormatError(
                f"{path}: packed header CRC mismatch (stored {stored:#010x}, "
                f"computed {computed:#010x}): header is corrupted"
            )
    return {
        "n": int(n), "m": int(m), "version": int(version),
        "has_edge_w": bool(flags & _FLAG_EDGE_W),
        "has_node_w": bool(flags & _FLAG_NODE_W),
        "n_total": float(n_total), "m_total": float(m_total),
    }


class PackedChunkReader:
    """Incremental reader for the packed format with a bounded byte buffer.

    Version-2 sections are CRC-verified with a rolling crc32 over consumed
    payload bytes — a mismatch raises `StreamFormatError` at the section
    boundary, so residency never grows past the IO chunk.  `next_pos` is
    the resume token for the record after the last one yielded; for v2 its
    offset is always the enclosing section's header, with `skip` records to
    discard after the seek (the whole section re-verifies on resume).
    """

    def __init__(self, path: str, io_chunk_bytes: int = DEFAULT_IO_CHUNK,
                 *, opener=open, retry: "RetryPolicy | None" = DEFAULT_RETRY):
        self.path = path
        self.io_chunk_bytes = max(64, int(io_chunk_bytes))
        self.opener = opener
        self.retry = retry
        self._io_retries = [0]
        self.meta = read_packed_header(path, opener=opener, retry=retry,
                                       retry_counter=self._io_retries)
        self.bytes_read = 0
        self.resident_bytes = 0
        self.next_pos: dict = {
            "index": 0, "offset": _HEADER.size, "skip": 0, "directed": 0,
        }

    @property
    def io_retries(self) -> int:
        return self._io_retries[0]

    def records(self, start: "dict | None" = None):
        meta = self.meta
        has_ew, has_nw = meta["has_edge_w"], meta["has_node_w"]
        n = meta["n"]
        sectioned = meta["version"] >= 2
        if start is None:
            v0, seek_to, skip, directed = 0, _HEADER.size, 0, 0
        else:
            v0 = int(start["index"])
            seek_to = int(start["offset"])
            skip = int(start.get("skip", 0))
            directed = int(start["directed"])
        f = _retrying(lambda: self.opener(self.path, "rb"), self.retry, self._io_retries)
        with f:
            f.seek(seek_to)
            buf = bytearray()
            pos = 0
            abs_off = seek_to        # file offset of buf[pos]
            sec_left = 0             # payload bytes left in the open section
            sec_crc = 0              # rolling crc32 of consumed payload
            sec_expect = 0           # the section header's crc32
            sec_start = seek_to      # file offset of the open section header
            sec_consumed = 0         # records consumed from the open section

            def ensure(k: int) -> bool:
                nonlocal buf, pos
                while len(buf) - pos < k:
                    chunk = _read_retrying(f, self.io_chunk_bytes, self.retry, self._io_retries)
                    if not chunk:
                        return False
                    self.bytes_read += len(chunk)
                    if pos:  # drop consumed bytes before growing
                        del buf[:pos]
                        pos = 0
                    buf += chunk
                return True

            def open_section(v: int) -> None:
                nonlocal pos, abs_off, sec_left, sec_crc, sec_expect, sec_start, sec_consumed
                if not ensure(_SECTION.size):
                    raise StreamFormatError(
                        f"{self.path}: truncated section header before record {v} (of {n})"
                    )
                sec_start = abs_off
                payload_len, sec_expect = _SECTION.unpack_from(buf, pos)
                pos += _SECTION.size
                abs_off += _SECTION.size
                if payload_len == 0:
                    raise StreamFormatError(
                        f"{self.path}: empty section at offset {sec_start}"
                    )
                sec_left = payload_len
                sec_crc = 0
                sec_consumed = 0

            def close_section() -> None:
                nonlocal sec_left
                if sec_crc != sec_expect:
                    raise StreamFormatError(
                        f"{self.path}: CRC mismatch in section at offset {sec_start} "
                        f"(stored {sec_expect:#010x}, computed {sec_crc:#010x}): "
                        "file is corrupted"
                    )
                sec_left = 0

            consumed_skip = 0
            v = v0
            while v < n or consumed_skip < skip:
                if sectioned and sec_left == 0:
                    open_section(v)
                if not ensure(4):
                    raise StreamFormatError(
                        f"{self.path}: truncated at record {v} (of {n})"
                    )
                (deg,) = _U32.unpack_from(buf, pos)  # peek; pos unchanged
                rec_bytes = 4 + (4 if has_nw else 0) + 4 * deg + (4 * deg if has_ew else 0)
                if sectioned and rec_bytes > sec_left:
                    raise StreamFormatError(
                        f"{self.path}: record {v} (deg={deg}) overruns its section "
                        f"at offset {sec_start}: file is corrupted or truncated"
                    )
                if not ensure(rec_bytes):
                    raise StreamFormatError(
                        f"{self.path}: truncated inside record {v} (deg={deg})"
                    )
                # ensure() may compact, but never past pos — the record
                # always starts at the (possibly relocated) current pos
                rec_start = pos
                pos += 4
                node_w = 1.0
                if has_nw:
                    (node_w,) = _F32.unpack_from(buf, pos)
                    pos += 4
                raw = np.frombuffer(buf, dtype="<u4", count=deg, offset=pos)
                nbrs = raw.astype(np.int32)
                # one reduction on the raw u4 view covers both failure modes:
                # ids >= n, and ids >= 2^31 (which would wrap negative in the
                # int32 cast) are both >= n as unsigned.  The view must die
                # here — a live export blocks the bytearray compaction in
                # ensure() with a BufferError.
                umax = int(raw.max()) if deg else -1
                del raw
                pos += 4 * deg
                if has_ew:
                    wts = np.frombuffer(buf, dtype="<f4", count=deg, offset=pos).copy()
                    pos += 4 * deg
                else:
                    wts = _unit_weights(deg)
                abs_off += rec_bytes
                if sectioned:
                    sec_crc = zlib.crc32(memoryview(buf)[rec_start:pos], sec_crc)
                    sec_left -= rec_bytes
                    sec_consumed += 1
                    if sec_left == 0:
                        close_section()
                if consumed_skip < skip:
                    # resume discard: bytes already count toward the CRC
                    consumed_skip += 1
                    continue
                if umax >= n:
                    raise StreamFormatError(
                        f"{self.path}: record {v}: neighbor id out of range [0, {n})"
                    )
                directed += int(deg)
                self.resident_bytes = len(buf) - pos
                v += 1
                if sectioned and sec_left > 0:
                    self.next_pos = {
                        "index": v, "offset": sec_start,
                        "skip": sec_consumed, "directed": directed,
                    }
                else:
                    self.next_pos = {
                        "index": v, "offset": abs_off, "skip": 0, "directed": directed,
                    }
                yield nbrs, wts, node_w
            if sectioned and sec_left > 0:
                raise StreamFormatError(
                    f"{self.path}: section at offset {sec_start} has {sec_left} "
                    f"payload bytes past the last record: file is corrupted"
                )
            if directed != 2 * meta["m"]:
                raise StreamFormatError(
                    f"{self.path}: header m={meta['m']} but {directed} directed entries"
                )
            self.resident_bytes = 0


# ------------------------------------------------------------- disk stream


class DiskNodeStream(NodeStreamBase):
    """Disk-backed NodeStream: bounded read-ahead, no materialized CSR.

    Detects the format by magic (packed) vs text (METIS).  Aggregate totals
    come from the packed header, or — for METIS text — from the header
    directly (fmt 00) or a one-shot counting pre-pass (weighted formats).
    Iterating opens a fresh reader, so multiple passes (restreaming) work.

    `tell()` / `iter_from(token)` expose resumable iteration for
    checkpoint/resume; `crc_protected` says whether the backing file
    carries per-section CRCs (packed v2) or streams unverified (METIS
    text, packed v1); `io_retries` counts transient-IO retries absorbed by
    the hardened readers.
    """

    def __init__(self, path: str, io_chunk_bytes: int = DEFAULT_IO_CHUNK,
                 *, opener=open, retry: "RetryPolicy | None" = DEFAULT_RETRY):
        self.path = path
        self.io_chunk_bytes = int(io_chunk_bytes)
        self.opener = opener
        self.retry = retry
        self._reader: MetisChunkReader | PackedChunkReader | None = None
        self._bytes_read_done = 0
        self._io_retries_done = 0

        def _magic() -> bytes:
            with opener(path, "rb") as f:
                return _read_exact(f, 4)

        init_retries = [0]
        self._packed = _retrying(_magic, retry, init_retries) == MAGIC
        self._io_retries_done += init_retries[0]
        if self._packed:
            hdr_retries = [0]
            meta = read_packed_header(path, opener=opener, retry=retry,
                                      retry_counter=hdr_retries)
            self._io_retries_done += hdr_retries[0]
            self.n, self.m = meta["n"], meta["m"]
            self._totals: tuple[float, float] | None = (meta["n_total"], meta["m_total"])
            self.has_edge_w = meta["has_edge_w"]
            self.has_node_w = meta["has_node_w"]
            self.crc_protected = meta["version"] >= 2
        else:
            r = self._make_reader()
            self.n, self.m, self.has_node_w, self.has_edge_w = r.header()
            self._bytes_read_done += r.bytes_read
            self._io_retries_done += r.io_retries
            self.crc_protected = False
            # fmt 00: unit weights make the canonical f64 sums exact integers
            weighted = self.has_node_w or self.has_edge_w
            self._totals = None if weighted else (float(self.n), float(self.m))

    def _make_reader(self) -> "MetisChunkReader | PackedChunkReader":
        cls = PackedChunkReader if self._packed else MetisChunkReader
        return cls(self.path, self.io_chunk_bytes, opener=self.opener, retry=self.retry)

    # ----------------------------------------------------------- aggregates
    def _compute_totals(self) -> tuple[float, float]:
        if self._totals is None:
            # weighted METIS text: one counting pre-pass (O(n) state only)
            deg_w = np.zeros(self.n, dtype=np.float64)
            node_w = np.ones(self.n, dtype=np.float32)
            r = self._make_reader()
            for v, (_, wts, nw) in enumerate(r.records()):
                deg_w[v] = seq_sum64(wts)
                node_w[v] = nw
            self._bytes_read_done += r.bytes_read
            self._io_retries_done += r.io_retries
            self._totals = canonical_totals(deg_w, node_w)
        return self._totals

    @property
    def n_total(self) -> float:
        return self._compute_totals()[0]

    @property
    def m_total(self) -> float:
        return self._compute_totals()[1]

    @property
    def resident_bytes(self) -> int:
        r = self._reader  # snapshot: the reader thread may clear it
        return r.resident_bytes if r is not None else 0

    @property
    def bytes_read(self) -> int:
        r = self._reader
        return self._bytes_read_done + (r.bytes_read if r is not None else 0)

    @property
    def io_retries(self) -> int:
        r = self._reader
        return self._io_retries_done + (r.io_retries if r is not None else 0)

    # ------------------------------------------------------------ iteration
    def __iter__(self):
        return self._iterate(None)

    def tell(self) -> dict:
        r = self._reader
        if r is None:
            start = _HEADER.size if self._packed else 0
            return {"index": 0, "offset": start, "skip": 0, "directed": 0}
        return dict(r.next_pos)

    def iter_from(self, pos: dict):
        return self._iterate(dict(pos))

    def _iterate(self, pos: "dict | None"):
        reader = self._make_reader()
        self._reader = reader
        v = 0 if pos is None else int(pos["index"])
        try:
            for nbrs, wts, node_w in reader.records(pos):
                yield v, nbrs, wts, node_w
                v += 1
        finally:
            self._bytes_read_done += reader.bytes_read
            self._io_retries_done += reader.io_retries
            self._reader = None


def open_stream(path: str, io_chunk_bytes: int = DEFAULT_IO_CHUNK, **kw) -> DiskNodeStream:
    """Open a graph file (METIS text or packed binary) as a disk stream."""
    return DiskNodeStream(path, io_chunk_bytes, **kw)


# ---------------------------------------------------------------- writers


def write_packed(g, path: str, *, version: int = PACKED_VERSION,
                 section_records: int = SECTION_RECORDS,
                 section_bytes: int = SECTION_BYTES) -> None:
    """Write a CSRGraph or any NodeStream to the packed format.

    Given a stream, this is a pure disk-to-disk conversion: only one record
    is resident at a time.
    """
    stream = as_node_stream(g)
    with PackedWriter(
        path, stream.n, stream.m,
        has_edge_w=getattr(stream, "has_edge_w", True),
        has_node_w=getattr(stream, "has_node_w", True),
        version=version, section_records=section_records, section_bytes=section_bytes,
    ) as w:
        for _, nbrs, wts, node_w in stream:
            w.write_node(nbrs, wts, node_w)


def materialize_records(n: int, records) -> CSRGraph:
    """Assemble a CSRGraph from an iterable of (nbrs, weights, node_w)
    stream records — the shared tail of read_metis / read_packed."""
    indptr = np.zeros(n + 1, dtype=np.int64)
    indices: list[np.ndarray] = []
    weights: list[np.ndarray] = []
    node_w = np.ones(n, dtype=np.float32)
    for v, (nbrs, wts, nw) in enumerate(records):
        indices.append(nbrs)
        weights.append(wts)
        node_w[v] = nw
        indptr[v + 1] = indptr[v] + nbrs.size
    return CSRGraph(
        indptr=indptr,
        indices=np.concatenate(indices) if indices else np.empty(0, dtype=np.int32),
        edge_w=np.concatenate(weights) if weights else np.empty(0, dtype=np.float32),
        node_w=node_w,
    )


def read_packed(path: str, io_chunk_bytes: int = DEFAULT_IO_CHUNK) -> CSRGraph:
    """Materialize a packed file as a CSRGraph (tests / small graphs only)."""
    read_packed_header(path)  # validate magic/version up front
    stream = DiskNodeStream(path, io_chunk_bytes)
    return materialize_records(stream.n, (rec[1:] for rec in stream))


# ------------------------------------------------------- shard splitting


def shard_ranges(n: int, workers: int) -> "list[tuple[int, int]]":
    """Contiguous near-equal id ranges [(lo, hi), ...] covering [0, n).

    Same span arithmetic as `permute_to_disk`'s destination-range buckets:
    span = ceil(n / workers), so every range but the last has identical
    width and empty trailing ranges are dropped (n < workers collapses to
    fewer, single-node shards).
    """
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if workers < 1:
        raise ValueError(f"workers must be >= 1, got {workers}")
    if n == 0:
        return [(0, 0)]
    span = max(1, (n + workers - 1) // workers)
    return [(lo, min(lo + span, n)) for lo in range(0, n, span)]


def shard_boundary_pass(
    stream: DiskNodeStream, ranges: "list[tuple[int, int]]"
) -> "tuple[list[dict], int]":
    """One bounded scan collecting the resume token at each shard's first
    record — the disk-source shard split.

    An id-contiguous split needs only the byte position where each range
    starts: workers then `iter_from` their token on private file handles
    and read nothing outside their range.  The scan parses up to the last
    boundary (not the whole file) and returns the tokens plus the bytes it
    read; for v2 packed files each token re-enters at a section start, so
    the CRC re-verification survives the split.
    """
    tokens: "list[dict]" = [stream.tell()]  # range 0 starts at the head
    it = iter(stream)
    v = 0
    for lo, _hi in ranges[1:]:
        while v < lo:
            try:
                next(it)
            except StopIteration:
                raise StreamFormatError(
                    f"{stream.path}: stream ended at record {v} while "
                    f"scanning for the shard boundary at {lo}"
                ) from None
            v += 1
        tokens.append(stream.tell())
    it.close()
    return tokens, stream.bytes_read


# ------------------------------------------------------- on-disk permute


def _canonical_row_order(nbrs: np.ndarray, v: int, n: int) -> np.ndarray:
    """Sort positions so neighbors > v come first ascending, then < v
    ascending — exactly the row order `CSRGraph.from_edges` emits."""
    nb = nbrs.astype(np.int64)
    key = nb + (nb < v) * np.int64(n)
    return np.argsort(key, kind="stable")


def permute_to_disk(
    in_path: str,
    perm: np.ndarray,
    out_path: str,
    *,
    shard_nodes: int = 1 << 14,
    io_chunk_bytes: int = DEFAULT_IO_CHUNK,
) -> None:
    """Realize a stream ordering on disk: relabel so new node t == old node
    perm[t], without materializing the graph.

    Pass 1 streams the input, relabels each record, canonicalizes its row
    order, and appends it to the shard file owning its new id range.  Pass 2
    loads one shard at a time (≤ shard_nodes rows resident), orders it, and
    appends to the output.  Output rows are bit-identical to streaming
    `apply_order(g, perm)` from memory.
    """
    perm = np.asarray(perm, dtype=np.int64)
    stream = DiskNodeStream(in_path, io_chunk_bytes)
    n, m = stream.n, stream.m
    if perm.shape[0] != n:
        raise ValueError(f"perm has {perm.shape[0]} entries, graph has {n} nodes")
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n, dtype=np.int64)

    span = max(1, int(shard_nodes))
    n_shards = max(1, (n + span - 1) // span)
    # scratch spill files, tmp-named and deleted in the finally below
    shard_paths = [f"{out_path}.tmp.shard{s}" for s in range(n_shards)]
    shard_files = [open(p, "wb") for p in shard_paths]  # repro: noqa RPR005 -- tmp-named scratch spills, deleted in the finally below
    try:
        for v, nbrs, wts, node_w in stream:
            nv = int(inv[v])
            rn = inv[nbrs.astype(np.int64)]
            order = _canonical_row_order(rn, nv, n)
            rn, rw = rn[order], wts[order]
            f = shard_files[nv // span]
            f.write(struct.pack("<QIf", nv, rn.shape[0], node_w))
            f.write(rn.astype("<u4").tobytes())
            f.write(rw.astype("<f4").tobytes())
        for f in shard_files:
            f.close()
        with PackedWriter(
            out_path, n, m,
            has_edge_w=stream.has_edge_w, has_node_w=stream.has_node_w,
        ) as w:
            for s, sp in enumerate(shard_paths):
                rows: dict[int, tuple[np.ndarray, np.ndarray, float]] = {}
                with _retrying(lambda sp=sp: open(sp, "rb"), DEFAULT_RETRY) as f:
                    data = _read_retrying(f, -1, DEFAULT_RETRY)
                pos = 0
                while pos < len(data):
                    nv, deg, node_w = struct.unpack_from("<QIf", data, pos)
                    pos += 16
                    rn = np.frombuffer(data, dtype="<u4", count=deg, offset=pos).astype(np.int32)
                    pos += 4 * deg
                    rw = np.frombuffer(data, dtype="<f4", count=deg, offset=pos).copy()
                    pos += 4 * deg
                    rows[nv] = (rn, rw, float(node_w))
                lo, hi = s * span, min((s + 1) * span, n)
                if len(rows) != hi - lo:
                    raise StreamFormatError(
                        f"permute shard {s}: {len(rows)} rows, expected {hi - lo}"
                    )
                for nv in range(lo, hi):
                    rn, rw, nw = rows[nv]
                    w.write_node(rn, rw, nw)
    finally:
        for f in shard_files:
            if not f.closed:
                f.close()
        for sp in shard_paths:
            if os.path.exists(sp):
                os.remove(sp)
