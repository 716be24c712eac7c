"""MVCC snapshot → coprocessor scan feed.

A copy of the JAX package's ``copr/storage_impl.py``: the feed the node
hands the host pipeline for a plan that does not start with a TableScan.

Reference: src/coprocessor/dag/storage_impl.rs (``TikvStorage`` adapts the
txn layer's Store/Scanner to the executor-facing ``Storage`` trait —
begin_scan/scan_next/get, tidb_query_common/src/storage/mod.rs:21-32).
This adapter serves the host row path; large scans additionally build a
columnar snapshot once and reuse it (the device feed).
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..executors.ranges import KeyRange
from ..storage.mvcc.reader import MvccReader


class MvccScanStorage:
    """ScanStorage (executors/storage.py protocol) over one MVCC snapshot
    at a fixed read_ts."""

    def __init__(self, reader: MvccReader, read_ts: int,
                 bypass_locks=()):
        self._reader = reader
        self._read_ts = read_ts
        self._bypass = bypass_locks
        self._ranges: list[KeyRange] = []
        self._desc = False
        self._range_idx = 0
        self._buf: list[tuple[bytes, bytes]] = []
        self._buf_pos = 0
        self._exhausted = False
        self._resume_key: Optional[bytes] = None

    # -- ScanStorage --

    def begin_scan(self, ranges: Sequence[KeyRange],
                   desc: bool = False) -> None:
        # desc scans walk the (sorted) range list in reverse so keys come
        # out in global reverse order
        self._ranges = list(reversed(ranges)) if desc else list(ranges)
        self._desc = desc
        self._range_idx = 0
        self._buf = []
        self._buf_pos = 0
        self._exhausted = False
        self._resume_key = None

    def _fill(self, want: int) -> None:
        """Pull the next batch of visible pairs from the MVCC scanner."""
        self._buf = []
        self._buf_pos = 0
        while self._range_idx < len(self._ranges):
            r = self._ranges[self._range_idx]
            if self._desc:
                start, end = r.start, self._resume_key or r.end
            else:
                start, end = self._resume_key or r.start, r.end
            got = self._reader.scan(start, end, max(want, 64),
                                    self._read_ts, self._desc,
                                    self._bypass)
            if got:
                self._buf = got
                if self._desc:
                    self._resume_key = got[-1][0]       # exclusive end
                else:
                    self._resume_key = got[-1][0] + b"\x00"
                if len(got) < max(want, 64):
                    self._range_idx += 1
                    self._resume_key = None
                    # keep buffered rows; next _fill moves to next range
                return
            self._range_idx += 1
            self._resume_key = None
        self._exhausted = True

    def scan_next(self) -> Optional[tuple[bytes, bytes]]:
        if self._buf_pos >= len(self._buf):
            if self._exhausted:
                return None
            self._fill(64)
            if not self._buf:
                return None
        kv = self._buf[self._buf_pos]
        self._buf_pos += 1
        return kv

    def scan_batch(self, n: int) -> list[tuple[bytes, bytes]]:
        out: list[tuple[bytes, bytes]] = []
        while len(out) < n:
            if self._buf_pos >= len(self._buf):
                if self._exhausted:
                    break
                self._fill(n - len(out))
                if not self._buf:
                    break
            take = min(n - len(out), len(self._buf) - self._buf_pos)
            out.extend(self._buf[self._buf_pos:self._buf_pos + take])
            self._buf_pos += take
        return out

    def get(self, key: bytes) -> Optional[bytes]:
        return self._reader.get(key, self._read_ts, self._bypass)
