"""Bounded priority buffer: `BucketPQ`, the paper's Algorithm 2.

An array of B dynamic arrays keyed by the discretized score
idx(v) = min(round(s*discFactor), B-1), a location map L[v] = (bucket, pos)
and a top pointer rho.  Insert / IncreaseKey are O(1) amortized, ExtractMax
O(1) amortized and O(B) worst case.  This is the sequential driver's hot
path; its extraction order is held equal to `repro.core.buffer.BucketPQ`.
"""
from __future__ import annotations

_HOLE = -1  # tombstone marker (node ids are >= 0)


class BucketPQ:
    """Paper Algorithm 2. Keys are discretized scores; ties break LIFO.

    Middle-of-bucket removal (IncreaseKey moving a node up) tombstones the
    vacated slot instead of swapping the tail into it: positions in the
    location map stay stable, each tombstone is popped exactly once from the
    tail, and the within-bucket LIFO order of the remaining nodes is
    preserved (DESIGN.md §3.2).  A moved node is re-appended to its new
    bucket, so only a genuine bucket increase refreshes its LIFO stamp.
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

    def insert(self, v: int, s: float) -> None:
        b = self.idx(s)
        bucket = self.buckets[b]
        bucket.append(v)
        self.loc[v] = (b, len(bucket) - 1)
        if b > self.rho:
            self.rho = b
        self._size += 1

    def increase_key(self, v: int, s: float) -> None:
        b_old, p = self.loc[v]
        b_new = self.idx(s)
        if b_new <= b_old:
            # same bucket or attempted decrease: IncreaseKey is a no-op
            return
        bucket = self.buckets[b_old]
        if p == len(bucket) - 1:
            bucket.pop()  # tail: remove directly, no hole
            self._pop_tombstones(b_old)
        else:
            bucket[p] = _HOLE  # positions of the others stay valid
            self._holes[b_old] += 1
            if self._holes[b_old] > len(bucket) - self._holes[b_old]:
                self._compact(b_old)  # amortized O(1): holes outnumber live
        del self.loc[v]
        self._size -= 1
        self.insert(v, s)

    def _pop_tombstones(self, b: int) -> None:
        bucket = self.buckets[b]
        while bucket and bucket[-1] == _HOLE:
            bucket.pop()
            self._holes[b] -= 1

    def _compact(self, b: int) -> None:
        """Drop a bucket's tombstones, preserving live order and refreshing
        the location map."""
        live = [v for v in self.buckets[b] if v != _HOLE]
        self.buckets[b] = live
        self._holes[b] = 0
        for p, v in enumerate(live):
            self.loc[v] = (b, p)

    def extract_max(self) -> int:
        self._pop_tombstones(self.rho)
        while self.rho > 0 and not self.buckets[self.rho]:
            self.rho -= 1  # rare worst-case O(B)
            self._pop_tombstones(self.rho)
        v = self.buckets[self.rho].pop()
        del self.loc[v]
        self._size -= 1
        self._pop_tombstones(self.rho)
        return v
