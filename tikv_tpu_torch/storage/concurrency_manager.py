"""Concurrency manager — in-memory lock table + global max_ts.

A copy of the JAX package's ``storage/concurrency_manager.py``.

Reference: components/concurrency_manager/src/lib.rs:1-15 (the async
commit substrate): every read updates the global ``max_ts`` BEFORE
resolving data, and an async-commit prewrite (a) publishes its lock in
the in-memory table first, (b) computes
``min_commit_ts = max(max_ts + 1, start_ts + 1, caller hint)``, then
(c) persists the engine lock.  Any read concurrent with that window
either bumped max_ts first (so min_commit_ts exceeds its read_ts) or
sees the memory lock and blocks — the commit_ts can therefore be
decided at prewrite time with no second PD round-trip.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from .mvcc.errors import KeyIsLocked
from .txn_types import Lock


class ConcurrencyManager:
    def __init__(self):
        self._max_ts = 0
        self._mu = threading.Lock()
        self._table: dict[bytes, Lock] = {}     # key -> memory lock

    # -- max_ts (lib.rs update_max_ts / max_ts) --

    def update_max_ts(self, ts: int) -> None:
        with self._mu:
            if ts > self._max_ts:
                self._max_ts = ts

    @property
    def max_ts(self) -> int:
        return self._max_ts

    # -- memory lock table (lock_table.rs) --

    def lock_keys(self, keys, locks) -> None:
        """Publish memory locks (prewrite step a)."""
        with self._mu:
            for k, lk in zip(keys, locks):
                self._table[k] = lk

    def unlock_keys(self, keys) -> None:
        with self._mu:
            for k in keys:
                self._table.pop(k, None)

    def memory_lock_of(self, key: bytes) -> Optional[Lock]:
        return self._table.get(key)

    # -- read-side checks (storage reads + copr snapshots) --

    def read_key_check(self, key: bytes, read_ts: int,
                       bypass_locks=()) -> None:
        lk = self._table.get(key)
        if lk is not None and self._blocks(lk, read_ts, bypass_locks):
            raise KeyIsLocked(key, lk)

    def read_range_check(self, start: Optional[bytes],
                         end: Optional[bytes], read_ts: int,
                         bypass_locks=()) -> None:
        if not self._table:
            return
        with self._mu:
            items = list(self._table.items())
        for k, lk in items:
            if start is not None and k < start:
                continue
            if end is not None and k >= end:
                continue
            if self._blocks(lk, read_ts, bypass_locks):
                raise KeyIsLocked(k, lk)

    def read_ranges_check(self, ranges, read_ts: int,
                          bypass_locks=()) -> None:
        """Range check against coprocessor DAG key ranges — only memory
        locks inside the request's ranges block it, mirroring the
        engine-lock scoping of the row scanner.  Both the lock table
        and DAG ranges are RAW user keys (table record keys), compared
        directly — the same comparison MvccColumnarSnapshot.check_locks
        uses for engine locks."""
        if not self._table:
            return
        with self._mu:
            items = list(self._table.items())
        for k, lk in items:
            if not self._blocks(lk, read_ts, bypass_locks):
                continue
            for r in ranges:
                if r.start <= k < r.end:
                    raise KeyIsLocked(k, lk)

    def read_region_check(self, region, read_ts: int,
                          bypass_locks=()) -> None:
        """Scope the memory-lock check to one REGION (replica-read
        veto): lock keys are raw user keys; region boundaries live in
        the encoded txn keyspace, so each key encodes for the compare."""
        if not self._table:
            return
        from .txn_types import encode_key
        with self._mu:
            items = list(self._table.items())
        for k, lk in items:
            if not self._blocks(lk, read_ts, bypass_locks):
                continue
            if region.contains(encode_key(k)):
                raise KeyIsLocked(k, lk)

    @staticmethod
    def _blocks(lk: Lock, read_ts: int, bypass_locks) -> bool:
        from .txn_types import LockType
        if lk.start_ts in bypass_locks:
            return False
        if lk.lock_type in (LockType.LOCK, LockType.PESSIMISTIC):
            return False
        return lk.start_ts <= read_ts
