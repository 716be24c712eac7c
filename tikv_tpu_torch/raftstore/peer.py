"""Peer — one replica of one region: raft driving + apply; and the
engine snapshot clamped to one region.

A trimmed copy of the JAX package's ``raftstore/peer.py`` for a single
store driven synchronously: ``RegionSnapshot``, and ``RaftPeer`` with
proposals, ``handle_ready`` and the apply of data writes (put, delete,
delete_range and the SST ``ingest``), lease reads (``local_read``), read
barriers through the log (``propose_read``), ``step`` and ``tick``.  Not
here: the admin commands (split, merge, change peer, compact log,
compute/verify hash), which ``propose`` refuses with ``AdminNotSupported``;
replica and stale reads; the batch-system apply pool and async log
writes.

Reference: components/raftstore/src/store/peer.rs (Peer: propose :3612,
handle_raft_ready_append :2565) and fsm/apply.rs (exec_raft_cmd
:1370-1740, the write commands).  Read path, fastest first: leader LEASE
local reads (store/worker/read.rs LocalReader — ``local_read`` here,
served by raftkv.py without a proposal or log barrier while the lease
holds), then ReadIndex barriers (``propose_read``), the correctness
backstop whenever the lease cannot vouch.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Optional

from ..codec.keys import DATA_PREFIX, data_key
from ..engine.traits import CF_DEFAULT, KvEngine
from ..raft.messages import EntryType, HardState, Message
from ..raft.messages import Snapshot, SnapshotMetadata
from ..raft.raw_node import LEADER, RawNode
from .cmd import RaftCmd, exec_write_ops
from .metapb import (
    AdminNotSupported,
    EpochNotMatch,
    KeyNotInRegion,
    NotLeaderError,
    Peer as PeerMeta,
    Region,
)
from .peer_storage import (
    RAFT_INIT_LOG_INDEX,
    RAFT_INIT_LOG_TERM,
    PeerStorage,
    region_data_bounds,
)


@dataclass
class Proposal:
    index: int
    term: int
    cb: Callable            # cb(result | Exception)
    is_read: bool = False   # read barrier: snapshot served at apply time


class RegionSnapshot:
    """Engine snapshot clamped to one region, with the data-key prefix
    applied transparently.

    ``data_index`` stamps the last applied data-mutating entry index — the
    snapshot's data version for the columnar cache (read barriers and
    leader noops do not bump it, so repeated reads share a version).
    """

    data_index: Optional[int] = None
    apply_index: Optional[int] = None

    def __init__(self, snap, region: Region):
        self._snap = snap
        self.region = region

    def _check(self, key: bytes) -> bytes:
        if not self.region.contains(key):
            raise KeyNotInRegion(key, self.region)
        return data_key(key)

    def get_value_cf(self, cf: str, key: bytes):
        return self._snap.get_value_cf(cf, self._check(key))

    def get_value(self, key: bytes):
        return self.get_value_cf(CF_DEFAULT, key)

    def iterator_cf(self, cf: str, lower: Optional[bytes] = None,
                    upper: Optional[bytes] = None):
        rlo, rhi = region_data_bounds(self.region)
        lo = rlo if lower is None else max(rlo, data_key(lower))
        hi = rhi if upper is None else min(rhi, data_key(upper))
        return _PrefixStripIterator(self._snap.iterator_cf(cf, lo, hi))

    def range_cf(self, cf: str, lower: bytes, upper: bytes):
        """Bulk range read clamped to the region → (keys, values,
        prefix_skip); keys keep the data-key prefix, which prefix_skip
        counts."""
        rng = getattr(self._snap, "range_cf", None)
        if rng is None:
            return None
        rlo, rhi = region_data_bounds(self.region)
        lo = max(rlo, data_key(lower))
        hi = min(rhi, data_key(upper))
        if lo >= hi:
            return [], [], 0
        keys, vals, skip = rng(cf, lo, hi)
        return keys, vals, skip + 1


class _PrefixStripIterator:
    """Strips the data-key prefix so the layers above see user keys."""

    def __init__(self, it):
        self._it = it

    def valid(self):
        return self._it.valid()

    def seek(self, key: bytes):
        return self._it.seek(data_key(key))

    def seek_for_prev(self, key: bytes):
        return self._it.seek_for_prev(data_key(key))

    def seek_to_first(self):
        return self._it.seek_to_first()

    def seek_to_last(self):
        return self._it.seek_to_last()

    def next(self):
        return self._it.next()

    def prev(self):
        return self._it.prev()

    def key(self) -> bytes:
        return self._it.key()[len(DATA_PREFIX):]

    def value(self) -> bytes:
        return self._it.value()


class RaftPeer:
    def __init__(self, store, region: Region, peer_meta: PeerMeta,
                 engine: KvEngine, initial: bool = False, **raft_cfg):
        # serializes the drive loop against lease reads from handler
        # threads (the LocalReader seam)
        self.mu = threading.RLock()
        self.store = store
        self.meta = peer_meta
        self.engine = engine
        self.peer_storage = PeerStorage(engine, region)
        ms, applied = self.peer_storage.load()
        if initial and ms.last_index() == 0:
            # fresh bootstrap peer: in-memory marker matching
            # write_initial_state (the engine copy is in the same batch)
            meta0 = ms.snapshot.metadata
            ms.snapshot = Snapshot(SnapshotMetadata(
                RAFT_INIT_LOG_INDEX, RAFT_INIT_LOG_TERM,
                meta0.voters, meta0.learners))
            ms.set_hard_state(HardState(RAFT_INIT_LOG_TERM, 0,
                                        RAFT_INIT_LOG_INDEX))
            applied = RAFT_INIT_LOG_INDEX
        self.node = RawNode(peer_meta.id, ms, **raft_cfg)
        self.node.applied = max(self.node.applied, applied)
        # last applied entry that mutated data; restart conservatively
        # re-stamps at applied (one-time cache invalidation per restart).
        # data_index advances while a write batch is still being BUILT;
        # data_index_engine advances only after the batch hits the
        # engine — snapshots stamp the engine-durable version
        self.data_index = self.node.applied
        self.data_index_engine = self.node.applied
        self.proposals: list[Proposal] = []
        # sender metas seen on incoming messages (peer.rs peer_cache)
        self.peer_cache: dict[int, PeerMeta] = {}
        # applied-but-not-yet-notified observer events + role tracking
        self._pending_obs: list = []
        self._last_role = False
        # applied_engine tracks what the ENGINE holds: reads gate on
        # engine state, not raft bookkeeping
        self.applied_engine = self.node.applied
        self._prop_mu = threading.Lock()

    # ------------------------------------------------------------- props

    @property
    def region(self) -> Region:
        return self.peer_storage.region

    def is_leader(self) -> bool:
        return self.node.state == LEADER

    def leader_peer(self) -> Optional[PeerMeta]:
        lid = self.node.leader_id
        for p in self.region.peers:
            if p.id == lid:
                return p
        return None

    # ------------------------------------------------------------- propose

    def _check_header(self, cmd: RaftCmd) -> None:
        region = self.region
        if cmd.epoch.version != region.epoch.version:
            raise EpochNotMatch(region)
        for op in cmd.ops:
            if op.op == "ingest":
                # the SST's sorted first/last keys were range-checked
                # against this epoch before proposing (node.
                # ingest_sst_blob)
                continue
            if not region.contains(op.key):
                raise KeyNotInRegion(op.key, region)

    def propose(self, cmd: RaftCmd, cb: Callable) -> int:
        with self.mu:
            return self._propose_locked(cmd, cb)

    def _propose_locked(self, cmd: RaftCmd, cb: Callable) -> int:
        from ..utils.failpoint import fail_point
        fail_point("peer::before_propose")
        if cmd.admin is not None:
            raise AdminNotSupported(self.region.id, cmd.admin.kind)
        if not self.is_leader():
            raise NotLeaderError(self.region.id, self.leader_peer())
        self._check_header(cmd)
        index = self.node.propose(cmd.to_bytes())
        with self._prop_mu:
            self.proposals.append(Proposal(index, self.node.term, cb))
        return index

    def _snapshot(self, apply_index: int) -> RegionSnapshot:
        snap = RegionSnapshot(self.engine.snapshot(), self.region)
        snap.data_index = self.data_index_engine
        snap.apply_index = apply_index
        return snap

    def local_read(self) -> Optional[RegionSnapshot]:
        """Lease-based local read: serve an engine snapshot with NO raft
        round-trip when the leader lease is valid and this leader has
        applied into its own term (reference: store/worker/read.rs
        LocalReader + ReadDelegate — applied_term == term guarantees all
        writes acked by previous leaders are in the applied state; writes
        acked by THIS leader were applied before their ack fired)."""
        with self.mu:
            return self._local_read_locked()

    def _local_read_locked(self) -> Optional[RegionSnapshot]:
        from ..utils.failpoint import fail_point
        # a "return" action forces the lease miss path (read barrier)
        if fail_point("read::before_local_read") is not None:
            return None
        node = self.node
        if not self.is_leader() or not node.in_lease():
            return None
        if node.storage.term(self.applied_engine) != node.term:
            return None     # fresh leader: noop not applied yet
        return self._snapshot(self.applied_engine)

    def propose_read(self, cb: Callable) -> int:
        """Read barrier through the log (see module docstring)."""
        with self.mu:
            return self._propose_read_locked(cb)

    def _propose_read_locked(self, cb: Callable) -> int:
        if not self.is_leader():
            raise NotLeaderError(self.region.id, self.leader_peer())
        index = self.node.propose(b"")

        def on_applied(_result):
            if isinstance(_result, Exception):
                cb(_result)
            else:
                cb(self._snapshot(index))
        with self._prop_mu:
            self.proposals.append(Proposal(index, self.node.term,
                                           on_applied, is_read=True))
        return index

    # ------------------------------------------------------------- ready

    def handle_ready(self) -> list[Message]:
        """Persist, apply, return messages to send.  Reference:
        handle_raft_ready_append + the apply poller, collapsed into the
        synchronous drive."""
        from ..utils.failpoint import fail_point
        out: list[Message] = []
        while self.node.has_ready():
            fail_point("peer::handle_ready")
            rd = self.node.ready()
            if rd.snapshot is not None:
                raise RuntimeError(
                    f"region {self.region.id}: a raft snapshot reached a "
                    "single-store peer")
            wb = self.engine.write_batch()
            fail_point("raftlog::before_persist")
            meta = self.node.storage.snapshot.metadata
            self.peer_storage.persist(wb, rd.entries, rd.hard_state,
                                      truncated=(meta.index, meta.term))
            fail_point("apply::before_entries")
            cbs: list = []
            for entry in rd.committed_entries:
                if not entry.data and not wb.is_empty() and \
                        self._pending_read_at(entry.index, entry.term):
                    # flush the applied prefix so the read barrier's
                    # engine snapshot includes every earlier entry of
                    # this same ready batch
                    self.peer_storage.persist_apply(wb, entry.index - 1)
                    self.engine.write(wb)
                    self.data_index_engine = self.data_index
                    wb = self.engine.write_batch()
                self._apply_entry(wb, entry, cbs)
            if rd.committed_entries:
                self.peer_storage.persist_apply(
                    wb, rd.committed_entries[-1].index)
            fail_point("apply::before_write")
            if not wb.is_empty():
                self.engine.write(wb)
            fail_point("apply::after_write")
            if rd.committed_entries:
                self.data_index_engine = self.data_index
                # observers run AFTER the engine write so they only ever
                # see durable state (coprocessor/mod.rs post-apply hooks)
                self._dispatch_obs()
                self.applied_engine = rd.committed_entries[-1].index
            # ACKs leave only now — after the engine write
            for prop, res in cbs:
                prop.cb(res)
            out.extend(rd.messages)
            self.node.advance(rd)
        role = self.is_leader()
        if role != self._last_role:
            self._last_role = role
            self.store.coprocessor_host.notify_role_change(
                self.region.id, role)
        return out

    def _dispatch_obs(self) -> None:
        """Flush applied-entry observer events, post-engine-write."""
        if not self._pending_obs:
            return
        host = self.store.coprocessor_host
        for index, ops in self._pending_obs:
            host.notify_apply_write(self.region.id, index, ops)
        self._pending_obs.clear()

    # ------------------------------------------------------------- apply

    def _pending_read_at(self, index: int, term: int) -> bool:
        with self._prop_mu:
            for p in self.proposals:
                if p.index >= index:
                    return p.index == index and p.term == term \
                        and p.is_read
        return False

    def _take_proposal(self, index: int, term: int) -> Optional[Proposal]:
        stale = []
        got = None
        with self._prop_mu:
            while self.proposals and self.proposals[0].index <= index:
                p = self.proposals.pop(0)
                if p.index == index and p.term == term:
                    got = p
                    break
                stale.append(p)
        for p in stale:     # callbacks run outside the lock
            p.cb(NotLeaderError(self.region.id, self.leader_peer()))
        return got

    def _apply_entry(self, wb, entry, out_cbs: list) -> None:
        """Execute one committed entry into ``wb``; the proposal
        callback (the client's ACK) is APPENDED to ``out_cbs``, not
        fired — acks must not leave before the batch's engine write
        lands."""
        prop = self._take_proposal(entry.index, entry.term)
        if not entry.data:
            if prop is not None:
                out_cbs.append((prop, {}))  # read barrier / leader noop
            return
        if entry.entry_type is EntryType.CONF_CHANGE:
            raise AdminNotSupported(self.region.id, "change_peer")
        cmd = RaftCmd.from_bytes(entry.data)
        if cmd.admin is not None:
            raise AdminNotSupported(self.region.id, cmd.admin.kind)
        try:
            self._check_epoch_at_apply(cmd)
        except EpochNotMatch as e:
            if prop is not None:
                out_cbs.append((prop, e))
            return
        # only actual KV mutations bump the data version: the columnar
        # cache keys a line by it
        self.data_index = entry.index
        result = self._exec_write(wb, cmd)
        self._pending_obs.append((entry.index, cmd.ops))
        if prop is not None:
            out_cbs.append((prop, result))

    def _check_epoch_at_apply(self, cmd: RaftCmd) -> None:
        region = self.region
        if cmd.epoch.version != region.epoch.version:
            raise EpochNotMatch(region)

    def _exec_write(self, wb, cmd: RaftCmd) -> dict:
        # bulk SST ingest (fsm/apply.rs IngestSst) lands its whole sorted
        # runs without passing the observers' per-key path
        exec_write_ops(wb, cmd.ops)
        return {}

    # ------------------------------------------------------------- misc

    def step(self, msg: Message) -> None:
        self.node.step(msg)

    def tick(self) -> None:
        self.node.tick()
