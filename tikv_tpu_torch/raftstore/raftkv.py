"""RaftKv — the kv.Engine implemented by raft proposal + apply wait.

A trimmed copy of the JAX package's ``raftstore/raftkv.py`` for the
synchronous drive: lease reads, read barriers through the log, follower
reads by read index, stale reads (applied state, gated on the resolved-ts
watermark by the caller) and writes.  A replica read the leader takes is
a lease read, as in the reference.  The ``read::before_leader_read``
failpoint (``sleep(ms)``) slows the reads a leader serves — lease reads
and read barriers — and no stale or follower read.

Reference: src/server/raftkv/mod.rs (RaftKv: async_snapshot :603 routes
a read through the consensus/lease path; async_write :472 proposes a
RaftCmdRequest and resolves when applied).  The synchronous surface here
blocks on a ``driver`` callable that pumps the store loop until the
callback fires — the same shape as the reference blocking on the apply
callback.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..kv.engine import SnapContext, WriteData
from .cmd import RaftCmd, WriteOp
from .metapb import NotLeaderError
from .store import RaftStore


class RaftKv:
    def __init__(self, store: RaftStore,
                 driver: Optional[Callable[[Callable[[], bool]], None]] = None,
                 lock=None):
        self.store = store
        self._driver = driver if driver is not None else self._local_drive
        # serializes lease reads against the drive loop so the engine
        # snapshot and its data_index stamp are taken atomically
        self._lock = lock
        self.lease_reads = 0
        self.barrier_reads = 0
        self.stale_reads = 0

    def _local_drive(self, done: Callable[[], bool]) -> None:
        for _ in range(10000):
            if done():
                return
            if self.store.drive() == 0 and done():
                return
            self.store.tick()
        raise TimeoutError("raft command did not complete")

    def _wait(self, box: dict) -> None:
        self._driver(lambda: "result" in box)
        result = box["result"]
        if isinstance(result, Exception):
            raise result

    # -- kv.Engine --

    def snapshot(self, ctx: SnapContext):
        peer = self._route(ctx)
        if ctx.stale_read:
            # resolved-ts-gated local snapshot: correctness rests on the
            # caller's read_ts ≤ resolved_ts check (the node and the
            # service) — below the watermark no new commit can appear, so
            # any replica's applied state answers the MVCC read exactly
            self.stale_reads += 1
            return peer.stale_snapshot()
        if ctx.replica_read and not peer.is_leader():
            # follower read via ReadIndex: consistent at the leader's
            # commit point, zero leader load.  Registration holds the
            # node lock — the drive thread touches the same read state
            box: dict = {}
            cb = lambda r: box.__setitem__("result", r)  # noqa: E731
            if self._lock is not None:
                with self._lock:
                    peer.replica_read(cb, ctx.read_ts)
            else:
                peer.replica_read(cb, ctx.read_ts)
            self._wait(box)
            return box["result"]
        from ..utils.failpoint import fail_point
        fail_point("read::before_leader_read")
        # lease fast path (LocalReader): no proposal, no log barrier.
        # local_read serializes on the peer mutex; the node lock covers
        # the drive loop
        if self._lock is not None:
            with self._lock:
                snap = peer.local_read()
        else:
            snap = peer.local_read()
        if snap is not None:
            self.lease_reads += 1
            return snap
        self.barrier_reads += 1
        box: dict = {}
        peer.propose_read(lambda r: box.__setitem__("result", r))
        self._wait(box)
        return box["result"]

    def write(self, ctx: SnapContext, data: WriteData) -> None:
        key_hint = data.modifies[0][2] if data.modifies else b""
        peer = self._route(ctx, key_hint)
        ops = []
        for op, cf, key, value in data.modifies:
            if op == "put":
                ops.append(WriteOp("put", cf, key, value))
            else:
                ops.append(WriteOp("delete", cf, key))
        cmd = RaftCmd(peer.region.id, peer.region.epoch, tuple(ops))
        box: dict = {}
        peer.propose(cmd, lambda r: box.__setitem__("result", r))
        self._wait(box)

    def kv_engine(self):
        return self.store.engine

    # -- routing --

    def _route(self, ctx: SnapContext, key_hint: bytes = b""):
        if ctx.region_id:
            return self.store.region_peer(ctx.region_id)
        key = key_hint or ctx.key_hint
        if key:
            return self.store.peer_by_key(key)
        # single-region stores route trivially
        peers = list(self.store.peers.values())
        leaders = [p for p in peers if p.is_leader()]
        if len(leaders) == 1:
            return leaders[0]
        if len(peers) == 1:
            return peers[0]
        raise NotLeaderError(0)
