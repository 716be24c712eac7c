"""Engine trait + local implementation.

A copy of the JAX package's ``kv/engine.py``.

Reference: components/tikv_kv/src/lib.rs — ``Engine::async_snapshot``
(:368) and ``async_write`` (:386).  The TPU rebuild keeps the same seam:
the txn layer only sees snapshots and atomic write batches, so RaftKv
(consensus-backed) drops in without touching MVCC.  Python surface is
synchronous; the raft-backed impl internally waits for apply, exactly as
RaftKv blocks the callback (src/server/raftkv/mod.rs:407,472).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Protocol

from ..engine.memory import MemoryEngine
from ..engine.traits import KvEngine, Snapshot


@dataclass
class SnapContext:
    """Read context.  Reference: kvproto Context + SnapContext (tikv_kv):
    region routing + read options.  ``key_hint`` (an engine-keyspace key)
    lets the consensus engine route when region_id is unset — the
    reference's clients attach the region from PD; standalone callers
    route by key."""

    region_id: int = 0
    read_ts: int = 0
    key_hint: bytes = b""
    # serve from a FOLLOWER via ReadIndex (kvproto Context.replica_read)
    replica_read: bool = False
    # serve a local engine snapshot with NO consensus round trip
    # (kvproto Context.stale_read) — the caller must have verified
    # read_ts ≤ the region's resolved-ts watermark first
    stale_read: bool = False


@dataclass
class WriteData:
    """Atomic mutation set.  Reference: tikv_kv WriteData (modifies)."""

    modifies: list = field(default_factory=list)  # (op, cf, key, value?)

    @staticmethod
    def from_txn(txn) -> "WriteData":
        return WriteData(list(txn.modifies))


class Engine(Protocol):
    def snapshot(self, ctx: SnapContext) -> Snapshot: ...

    def write(self, ctx: SnapContext, data: WriteData) -> None: ...

    def kv_engine(self) -> KvEngine: ...


class LocalEngine:
    """Reference: tikv_kv BTreeEngine — local, non-replicated engine for
    the txn layer (tests + standalone)."""

    def __init__(self, kv: Optional[KvEngine] = None):
        self._kv = kv if kv is not None else MemoryEngine()

    def snapshot(self, ctx: SnapContext) -> Snapshot:
        return self._kv.snapshot()

    def write(self, ctx: SnapContext, data: WriteData) -> None:
        wb = self._kv.write_batch()
        for op, cf, key, value in data.modifies:
            if op == "put":
                wb.put_cf(cf, key, value)
            else:
                wb.delete_cf(cf, key)
        self._kv.write(wb)

    def kv_engine(self) -> KvEngine:
        return self._kv
