"""Resolved-ts tracking — per-region watermark below which no new
commit can appear.

A copy of the JAX package's ``cdc/resolved_ts.py``.  Reference:
components/resolved_ts/ — ``Resolver`` (resolver.rs:357) tracks the
start_ts of every pending lock it observes on the apply path; the advance
worker (advance.rs) ticks with a fresh TSO and publishes ``resolved_ts =
min(advanced ts, min pending lock ts - 1)``.  Readers may treat everything
at or below resolved_ts as final: a committed write's commit_ts always
exceeds its lock's start_ts, and the lock was tracked before the commit
record landed.  Followers learn the leader's watermark through the
``CheckLeader`` RPC (``server/node.py`` fans it out, ``server/service.py``
takes it) and serve stale reads at or below it.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..engine.traits import CF_LOCK
from ..raftstore.observer import Observer
from ..storage.txn_types import Lock, decode_key


class Resolver:
    """One region's pending-lock set + watermark (resolver.rs)."""

    def __init__(self, region_id: int):
        self.region_id = region_id
        self._locks: dict[bytes, int] = {}      # key -> start_ts
        self.resolved_ts = 0
        self._mu = threading.Lock()

    def track_lock(self, key: bytes, start_ts: int) -> None:
        with self._mu:
            self._locks[key] = start_ts

    def untrack_lock(self, key: bytes) -> None:
        with self._mu:
            self._locks.pop(key, None)

    def min_lock_ts(self) -> Optional[int]:
        with self._mu:
            return min(self._locks.values()) if self._locks else None

    def advance(self, ts: int) -> int:
        """Publish the watermark for a fresh TSO read ``ts``: never past a
        pending lock, never backwards."""
        m = self.min_lock_ts()
        candidate = ts if m is None else min(ts, m - 1)
        with self._mu:
            if candidate > self.resolved_ts:
                self.resolved_ts = candidate
            return self.resolved_ts


class ResolvedTsObserver(Observer):
    """Feeds Resolvers from the apply path (resolved_ts lib.rs:1-13).

    Locks are tracked from CF_LOCK puts and untracked on CF_LOCK deletes
    (commit, rollback).  The node's drive loop advances its leader
    regions (``advance_all``) and pushes the watermarks to the followers
    (``CheckLeader``)."""

    def __init__(self):
        self._resolvers: dict[int, Resolver] = {}
        self._mu = threading.Lock()

    def resolver(self, region_id: int) -> Resolver:
        with self._mu:
            r = self._resolvers.get(region_id)
            if r is None:
                r = self._resolvers[region_id] = Resolver(region_id)
            return r

    # -- Observer --

    def on_apply_write(self, region_id: int, index: int, ops) -> None:
        res = self.resolver(region_id)
        for op in ops:
            if op.cf != CF_LOCK:
                continue
            try:
                key = decode_key(op.key)
            except Exception:   # noqa: BLE001 — non-txn keyspace
                continue
            if op.op == "put":
                res.track_lock(key, Lock.from_bytes(op.value).start_ts)
            elif op.op == "delete":
                res.untrack_lock(key)

    def on_region_changed(self, region) -> None:
        # an epoch change keeps the resolver; a destroyed region's
        # resolver is simply no longer advanced
        pass

    # -- advance tick (node drive loop) --

    def advance_all(self, ts: int, leader_region_ids) -> dict:
        """Advance every leader region's watermark → {region_id:
        resolved_ts}."""
        return {rid: self.resolver(rid).advance(ts)
                for rid in leader_region_ids}
