"""Executor-facing KV storage feed.

Reference: components/tidb_query_common/src/storage/mod.rs:21-32 — the
``Storage`` trait that decouples executors from MVCC details, implemented
in tests by fixture stores; here ``begin_scan`` / ``scan_batch`` (up to N
pairs at once, so the row decode is one pass) / ``get``.  Columnar snapshots (``columnar.ColumnarTable``) are the other
feed: they have ``scan_columns`` and need no decode.
"""

from __future__ import annotations

import bisect
from typing import Iterable, Optional, Protocol, Sequence

from .ranges import KeyRange


class ScanStorage(Protocol):
    def begin_scan(self, ranges: Sequence[KeyRange],
                   desc: bool = False) -> None: ...

    def scan_batch(self, n: int) -> list[tuple[bytes, bytes]]: ...

    def get(self, key: bytes) -> Optional[bytes]: ...


class FixtureStorage:
    """Sorted in-memory KV (components/test_coprocessor fixture.rs)."""

    def __init__(self, pairs: Iterable[tuple[bytes, bytes]] = ()):
        data = sorted(pairs)
        self._keys = [k for k, _ in data]
        self._vals = [v for _, v in data]
        self._ranges: list[KeyRange] = []
        self._desc = False
        self._range_idx = 0
        self._pos = 0
        self._stop = 0

    def begin_scan(self, ranges: Sequence[KeyRange],
                   desc: bool = False) -> None:
        # desc scans walk the range list in reverse, so keys come out in
        # global reverse order
        self._ranges = list(reversed(ranges)) if desc else list(ranges)
        self._desc = desc
        self._range_idx = 0
        self._load_range()

    def _load_range(self) -> None:
        while self._range_idx < len(self._ranges):
            r = self._ranges[self._range_idx]
            lo = bisect.bisect_left(self._keys, r.start)
            hi = bisect.bisect_left(self._keys, r.end)
            if lo < hi:
                if self._desc:
                    self._pos, self._stop = hi - 1, lo - 1
                else:
                    self._pos, self._stop = lo, hi
                return
            self._range_idx += 1
        self._pos = self._stop = 0

    def scan_batch(self, n: int) -> list[tuple[bytes, bytes]]:
        out: list[tuple[bytes, bytes]] = []
        while len(out) < n:
            if self._range_idx >= len(self._ranges):
                break
            if self._pos == self._stop:
                self._range_idx += 1
                self._load_range()
                continue
            if self._desc:
                take = min(n - len(out), self._pos - self._stop)
                for i in range(self._pos, self._pos - take, -1):
                    out.append((self._keys[i], self._vals[i]))
                self._pos -= take
            else:
                take = min(n - len(out), self._stop - self._pos)
                out.extend(zip(self._keys[self._pos:self._pos + take],
                               self._vals[self._pos:self._pos + take]))
                self._pos += take
        return out

    def get(self, key: bytes) -> Optional[bytes]:
        i = bisect.bisect_left(self._keys, key)
        if i < len(self._keys) and self._keys[i] == key:
            return self._vals[i]
        return None
