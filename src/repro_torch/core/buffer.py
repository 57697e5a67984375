"""Bounded priority buffer: two implementations with one contract.

1. `BucketPQ` — the paper's Algorithm 2: an array of B dynamic arrays keyed
   by the discretized score idx(v) = min(round(s*discFactor), B-1), a
   location map L[v] = (bucket, pos) and a top pointer rho.  Insert /
   IncreaseKey are O(1) amortized, ExtractMax O(1) amortized and O(B) worst
   case.  The sequential and pipelined drivers' buffer.

2. `VectorBuffer` — the dense-vector buffer of the vectorized driver
   (DESIGN.md §3): scores live in dense vectors over node ids, eviction
   takes the top-`wave` composite keys (numpy argpartition on the host),
   and every rescore is a closed-form recompute from the counter vectors.
   With wave=1 it reproduces BucketPQ's extraction order exactly (same
   discretization, same LIFO tie-break).

Both stay on the host, as in the reference's drivers; their extraction
orders are held equal to `repro.core.buffer`'s.
"""
from __future__ import annotations

import numpy as np

_HOLE = -1  # tombstone marker (node ids are >= 0)


def _select_top(comp: np.ndarray, wave: int) -> np.ndarray:
    """Indices of the `wave` largest composite keys, descending.

    The composite keys are unique (stamps are globally unique), so this is
    a total order — the one tie-break both eviction engines share."""
    if wave < comp.size:
        part = np.argpartition(comp, comp.size - wave)[comp.size - wave :]
    else:
        part = np.arange(comp.size)
    return part[np.argsort(comp[part], kind="stable")[::-1]]


class BucketPQ:
    """Paper Algorithm 2. Keys are discretized scores; ties break LIFO.

    Middle-of-bucket removal (IncreaseKey moving a node up) tombstones the
    vacated slot instead of swapping the tail into it: positions in the
    location map stay stable, each tombstone is popped exactly once from the
    tail, and the within-bucket LIFO order of the remaining nodes is
    preserved (DESIGN.md §3.2).  A moved node is re-appended to its new
    bucket, so only a genuine bucket increase refreshes its LIFO stamp.

    The hot methods bind locals up front and inline the discretization and
    the tombstone pops: the pipelined driver's per-record loop calls them
    hundreds of thousands of times a second, where attribute lookups and
    helper calls are the cost.  `idx` stays the nameable discretization.
    """

    def __init__(self, s_max: float, disc_factor: int = 1000):
        self.disc = int(disc_factor)
        self.n_buckets = int(round(s_max * disc_factor)) + 1
        self.buckets: list[list[int]] = [[] for _ in range(self.n_buckets)]
        self.loc: dict[int, tuple[int, int]] = {}
        self.rho = 0
        self._size = 0
        self._holes = [0] * self.n_buckets  # live tombstones per bucket

    def idx(self, s: float) -> int:
        return min(int(round(s * self.disc)), self.n_buckets - 1)

    def __len__(self) -> int:
        return self._size

    def __contains__(self, v: int) -> bool:
        return v in self.loc

    def insert(self, v: int, s: float) -> None:
        b = int(round(s * self.disc))
        last = self.n_buckets - 1
        if b > last:
            b = last
        bucket = self.buckets[b]
        bucket.append(v)
        self.loc[v] = (b, len(bucket) - 1)
        if b > self.rho:
            self.rho = b
        self._size += 1

    def increase_key(self, v: int, s: float) -> None:
        b_old, p = self.loc[v]
        b_new = int(round(s * self.disc))
        last = self.n_buckets - 1
        if b_new > last:
            b_new = last
        if b_new <= b_old:
            # same bucket or attempted decrease: IncreaseKey is a no-op
            return
        bucket = self.buckets[b_old]
        if p == len(bucket) - 1:
            bucket.pop()  # tail: remove directly, no hole
            holes = self._holes
            while bucket and bucket[-1] == _HOLE:
                bucket.pop()
                holes[b_old] -= 1
        else:
            bucket[p] = _HOLE  # positions of the others stay valid
            self._holes[b_old] += 1
            if self._holes[b_old] > len(bucket) - self._holes[b_old]:
                self._compact(b_old)  # amortized O(1): holes outnumber live
        # re-append at the higher bucket (inlined `insert`; size unchanged)
        nbucket = self.buckets[b_new]
        nbucket.append(v)
        self.loc[v] = (b_new, len(nbucket) - 1)
        if b_new > self.rho:
            self.rho = b_new

    def _compact(self, b: int) -> None:
        """Drop a bucket's tombstones, preserving live order and refreshing
        the location map."""
        live = [v for v in self.buckets[b] if v != _HOLE]
        self.buckets[b] = live
        self._holes[b] = 0
        for p, v in enumerate(live):
            self.loc[v] = (b, p)

    def extract_max(self) -> int:
        buckets = self.buckets
        holes = self._holes
        rho = self.rho
        bucket = buckets[rho]
        while bucket and bucket[-1] == _HOLE:
            bucket.pop()
            holes[rho] -= 1
        while rho > 0 and not bucket:
            rho -= 1  # rare worst-case O(B)
            bucket = buckets[rho]
            while bucket and bucket[-1] == _HOLE:
                bucket.pop()
                holes[rho] -= 1
        self.rho = rho
        v = bucket.pop()
        del self.loc[v]
        self._size -= 1
        while bucket and bucket[-1] == _HOLE:
            bucket.pop()
            holes[rho] -= 1
        return v


class VectorBuffer:
    """Dense-score buffer: the vectorized driver's eviction engine.

    State is three dense vectors over global node ids: the in-buffer mask,
    the discretized score, and an insertion stamp that reproduces
    BucketPQ's LIFO tie-break (higher stamp wins within a bucket).
    `evict(wave)` returns the next `wave` nodes in the order a sequence of
    ExtractMax calls would give them *if scores did not change in between*
    — the wavefront approximation, exact for wave=1.

    Two eviction engines share this contract (DESIGN.md §3.2):

    * ``incremental`` (default) — a compact active-candidate array (append
      on insert, swap-delete on evict) plus per-bucket occupancy counts; an
      eviction scans the occupancy cumsum from the top bucket and the live
      candidates, O(occupancy + B), independent of n.
    * ``scan`` — a full rescan of all n slots per wave; the oracle of the
      equivalence tests.

    Both give bit-identical eviction orders (the composite key is a total
    order).
    """

    def __init__(self, n: int, s_max: float, disc_factor: int = 1000,
                 engine: str = "incremental"):
        if engine not in ("incremental", "scan"):
            raise ValueError(f"unknown eviction engine {engine!r}")
        self.engine = engine
        self.disc = int(disc_factor)
        self.n_buckets = int(round(s_max * disc_factor)) + 1
        self.in_buf = np.zeros(n, dtype=bool)
        self.key = np.zeros(n, dtype=np.int64)  # discretized score
        self.stamp = np.zeros(n, dtype=np.int64)
        self._next_stamp = 1
        self._size = 0
        # incremental engine: compact id/key/stamp arrays over live slots
        # (eviction reads no n-sized vector), a position map for O(1) slot
        # lookup, and per-bucket occupancy counts
        self._active = np.empty(n, dtype=np.int64)
        self._akey = np.empty(n, dtype=np.int64)
        self._astamp = np.empty(n, dtype=np.int64)
        self._pos = np.full(n, -1, dtype=np.int64)
        self._bucket_count = np.zeros(self.n_buckets, dtype=np.int64)
        self._rho = 0  # upper bound on the max occupied bucket

    def idx(self, s: np.ndarray | float) -> np.ndarray:
        return np.minimum(np.round(np.asarray(s) * self.disc).astype(np.int64),
                          self.n_buckets - 1)

    def __len__(self) -> int:
        return self._size

    def insert_many(self, vs: np.ndarray, scores: np.ndarray) -> None:
        vs = np.asarray(vs, dtype=np.int64)
        keys = np.asarray(self.idx(scores))
        # stamps preserve arrival order inside the insert batch
        stamps = np.arange(self._next_stamp, self._next_stamp + vs.size)
        self.in_buf[vs] = True
        self.key[vs] = keys
        self.stamp[vs] = stamps
        self._next_stamp += vs.size
        sl = slice(self._size, self._size + vs.size)
        self._active[sl] = vs
        self._akey[sl] = keys
        self._astamp[sl] = stamps
        self._pos[vs] = np.arange(self._size, self._size + vs.size)
        np.add.at(self._bucket_count, keys, 1)
        if vs.size:
            self._rho = max(self._rho, int(np.max(keys)))
        self._size += int(vs.size)

    def update_scores(self, vs: np.ndarray, scores: np.ndarray) -> None:
        """IncreaseKey semantics: stamps refresh only on a genuine bucket
        increase (the bucket PQ re-appends on a move); attempted decreases
        keep both the key and the stamp.  Non-members are ignored."""
        vs = np.asarray(vs, dtype=np.int64)
        live = self.in_buf[vs]
        if not live.all():  # a non-member's stale _pos would corrupt the
            vs = vs[live]   # compact arrays
            scores = np.asarray(scores)[live]
        new_key = np.asarray(self.idx(scores))
        old_key = self.key[vs]
        moved = new_key > old_key
        mv, mv_key = vs[moved], new_key[moved]
        if mv.size == 0:
            return
        stamps = np.arange(self._next_stamp, self._next_stamp + mv.size)
        self.key[mv] = mv_key
        self.stamp[mv] = stamps
        self._next_stamp += mv.size
        p = self._pos[mv]
        self._akey[p] = mv_key
        self._astamp[p] = stamps
        np.add.at(self._bucket_count, old_key[moved], -1)
        np.add.at(self._bucket_count, mv_key, 1)
        self._rho = max(self._rho, int(np.max(mv_key)))

    def evict(self, wave: int = 1) -> np.ndarray:
        """Pop the `wave` max-priority nodes (bucket desc, stamp desc)."""
        wave = min(wave, self._size)
        if wave == 0:
            return np.empty(0, dtype=np.int64)
        if self.engine == "scan":
            return self._evict_scan(wave)
        # lower the rho bound to the top non-empty bucket (amortized O(1))
        while self._rho > 0 and self._bucket_count[self._rho] == 0:
            self._rho -= 1
        # the lowest bucket the wave can reach, from the occupancy counted
        # down from the top: the candidates are the members of buckets at
        # or above it
        occ_desc = np.cumsum(self._bucket_count[: self._rho + 1][::-1])
        threshold = self._rho - int(np.searchsorted(occ_desc, wave))
        keys = self._akey[: self._size]
        cand = np.nonzero(keys >= threshold)[0]
        comp = keys[cand] * np.int64(self._next_stamp + 1) + self._astamp[: self._size][cand]
        positions = cand[_select_top(comp, wave)]
        out = self._active[positions]
        self._remove(out, positions)
        return out.astype(np.int64)

    def _remove(self, out: np.ndarray, positions: np.ndarray) -> None:
        """Swap-delete `positions` from the compact arrays: surviving tail
        occupants drop into the vacated low slots."""
        self.in_buf[out] = False
        self._pos[out] = -1
        np.add.at(self._bucket_count, self.key[out], -1)
        new_size = self._size - positions.size
        holes = positions[positions < new_size]
        tail_keep = np.ones(self._size - new_size, dtype=bool)
        tail_keep[positions[positions >= new_size] - new_size] = False
        movers_slots = np.nonzero(tail_keep)[0] + new_size
        if holes.size:
            mv_ids = self._active[movers_slots]
            self._active[holes] = mv_ids
            self._akey[holes] = self._akey[movers_slots]
            self._astamp[holes] = self._astamp[movers_slots]
            self._pos[mv_ids] = holes
        self._size = new_size

    def _evict_scan(self, wave: int) -> np.ndarray:
        ids = np.nonzero(self.in_buf)[0]
        # composite key: bucket * big + stamp (stamp < _next_stamp)
        comp = self.key[ids] * np.int64(self._next_stamp + 1) + self.stamp[ids]
        out = ids[_select_top(comp, wave)]
        self._remove(out, self._pos[out])
        return out.astype(np.int64)
