"""Peer — one replica of one region: raft driving + apply; and the
engine snapshot clamped to one region.

A copy of the JAX package's ``raftstore/peer.py`` for stores driven
synchronously: ``RegionSnapshot``, and ``RaftPeer`` with proposals,
``handle_ready`` (its snapshot and conf-change legs included), the apply
of data writes (put, delete, delete_range and the SST ``ingest``) and of
every admin command (split, prepare / commit / rollback merge, change peer
and its joint v2 form, compact log, compute and verify hash), region
snapshots for followers, the split checker's bookkeeping, lease reads
(``local_read``), read barriers through the log (``propose_read``) and
follower reads by read index (``replica_read``) and stale reads
(``stale_snapshot``: applied state with no consensus round trip, for a
read at or below the region's resolved-ts watermark).  Not here: the
batch-system apply pool and async log writes, and hibernation.

Reference: components/raftstore/src/store/peer.rs (Peer: propose :3612,
handle_raft_ready_append :2565) and fsm/apply.rs (exec_raft_cmd
:1370-1740 — write commands, and admin commands: split :1692, change
peer, compact log).  Read path, fastest first: leader LEASE local reads
(store/worker/read.rs LocalReader — ``local_read`` here, served by
raftkv.py without a proposal or log barrier while the lease holds), then
ReadIndex barriers (``propose_read`` / ``replica_read`` for followers),
the correctness backstop whenever the lease cannot vouch.
"""

from __future__ import annotations

import struct
import threading
from dataclasses import dataclass, replace
from itertools import chain
from typing import Callable, Optional

from ..codec.keys import DATA_PREFIX, data_key
from ..engine.traits import CF_DEFAULT, CF_LOCK, CF_RAFT, CF_WRITE, KvEngine
from ..raft.messages import (
    ConfChange,
    ConfChangeType,
    ConfChangeV2,
    EntryType,
    HardState,
    Message,
    Snapshot,
    SnapshotMetadata,
)
from ..raft.raw_node import LEADER, RawNode
from .cmd import (
    AdminCmd,
    RaftCmd,
    decode_change_peer_v2,
    encode_change_peer_v2,
    exec_write_ops,
)
from .metapb import (
    EpochNotMatch,
    InconsistentRegion,
    KeyNotInRegion,
    NotLeaderError,
    Peer as PeerMeta,
    Region,
    RegionEpoch,
    RegionMerging,
)
from .peer_storage import (
    RAFT_INIT_LOG_INDEX,
    RAFT_INIT_LOG_TERM,
    PeerStorage,
    decode_region,
    joint_state_key,
    merge_state_key,
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
            # fresh bootstrap/split peer: in-memory marker matching
            # write_initial_state (the engine copy is in the same batch)
            meta0 = ms.snapshot.metadata
            ms.snapshot = Snapshot(SnapshotMetadata(
                RAFT_INIT_LOG_INDEX, RAFT_INIT_LOG_TERM,
                meta0.voters, meta0.learners))
            ms.set_hard_state(HardState(RAFT_INIT_LOG_TERM, 0,
                                        RAFT_INIT_LOG_INDEX))
            applied = RAFT_INIT_LOG_INDEX
        ms.snapshot_provider = self._make_snapshot
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
        self.pending_destroy = False
        # PrepareMerge in flight: the prepare entry's apply index, or
        # None.  Persisted (merge_state_key) so a restarted source peer
        # keeps rejecting writes until commit/rollback.
        raw = engine.get_value_cf(CF_RAFT, merge_state_key(region.id))
        self.merging: Optional[int] = \
            int.from_bytes(raw, "big") if raw else None
        # sender metas seen on incoming messages — lets an uninitialized
        # peer route responses before it learns the region's peer list
        # (reference: peer.rs Peer::peer_cache)
        self.peer_cache: dict[int, PeerMeta] = {}
        # applied-but-not-yet-notified observer events + role tracking
        self._pending_obs: list = []
        self._last_role = False
        # (index, crc32) of the last applied ComputeHash
        self.consistency_state: Optional[tuple] = None
        # sub-region bucket boundaries (split-check pass computes them)
        self.buckets: list = []
        # split-check bookkeeping (fsm/apply.rs size_diff_hint +
        # SplitCheckTask): apply accumulates written bytes; the checker
        # only re-scans the region once the delta crosses
        # region_split_check_diff — a full region scan per tick would
        # stall the store (and contend every lease read) at scale
        self.approximate_size = 0
        self.size_diff_hint = 0
        # applied_engine tracks what the ENGINE holds: reads gate on
        # engine state, not raft bookkeeping
        self.applied_engine = self.node.applied
        self._prop_mu = threading.Lock()
        # replica reads (ReadIndex): ctx -> (cb, read_ts, age), plus
        # reads whose commit index the leader confirmed but we have not
        # applied up to yet
        self._replica_reads: dict[int, list] = {}
        self._replica_read_ctx = 0
        self._replica_waiting: list = []    # (index, cb)

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
        if cmd.epoch.version != region.epoch.version or \
                (cmd.admin is not None and
                 cmd.epoch.conf_ver != region.epoch.conf_ver):
            raise EpochNotMatch(region)
        for op in cmd.ops:
            if op.op == "ingest":
                # the SST's sorted first/last keys were range-checked
                # against this epoch before proposing (node.
                # ingest_sst_blob); a split in between fails the epoch
                # check at apply
                continue
            if not region.contains(op.key):
                raise KeyNotInRegion(op.key, region)

    def propose(self, cmd: RaftCmd, cb: Callable) -> int:
        with self.mu:
            return self._propose_locked(cmd, cb)

    def _propose_locked(self, cmd: RaftCmd, cb: Callable) -> int:
        from ..utils.failpoint import fail_point
        fail_point("peer::before_propose")
        if not self.is_leader():
            raise NotLeaderError(self.region.id, self.leader_peer())
        if self.merging is not None and (
                cmd.admin is None or
                cmd.admin.kind not in ("rollback_merge",)):
            # a merging source accepts only the rollback; everything
            # else retries after commit/rollback (ProposalInMergingMode)
            raise RegionMerging(self.region.id)
        self._check_header(cmd)
        if cmd.admin is not None and cmd.admin.kind == "change_peer":
            a = cmd.admin
            cc_type = {"add": ConfChangeType.ADD_NODE,
                       "add_learner": ConfChangeType.ADD_LEARNER,
                       "remove": ConfChangeType.REMOVE_NODE}[a.change_type]
            index = self.node.propose_conf_change(
                ConfChange(cc_type, a.peer.id, cmd.to_bytes()))
        elif cmd.admin is not None and cmd.admin.kind == "change_peer_v2":
            meta = decode_change_peer_v2(cmd.admin.extra)
            tmap = {"add": ConfChangeType.ADD_NODE,
                    "add_learner": ConfChangeType.ADD_LEARNER,
                    "remove": ConfChangeType.REMOVE_NODE}
            changes = tuple((tmap[c["t"]], c["peer"]["id"])
                            for c in meta["changes"])
            index = self.node.propose_conf_change_v2(ConfChangeV2(
                changes, cmd.to_bytes(),
                leave_joint=meta.get("leave", False)))
        else:
            index = self.node.propose(cmd.to_bytes())
        with self._prop_mu:
            self.proposals.append(Proposal(index, self.node.term, cb))
        return index

    def _snapshot(self, apply_index: int) -> RegionSnapshot:
        snap = RegionSnapshot(self.engine.snapshot(), self.region)
        snap.data_index = self.data_index_engine
        snap.apply_index = apply_index
        return snap

    def stale_snapshot(self) -> RegionSnapshot:
        """Engine snapshot with NO consensus round trip — only safe for
        reads at or below the region's resolved-ts watermark (closed
        timestamps: no commit at ts ≤ resolved_ts can newly appear), a
        gate the node enforces before calling this.  Serves from any
        replica, leader or not (kvproto Context stale_read)."""
        with self.mu:
            return self._snapshot(self.applied_engine)

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

    def replica_read(self, cb: Callable, read_ts: int = 0) -> None:
        """Follower/replica read (store read parallelism; reference:
        test_replica_read.rs flow over raft ReadIndex).  The snapshot is
        served once this peer has applied up to the commit index the
        LEADER confirmed — same consistency as a leader lease read, no
        leader load.  Dropped requests (no leader yet, leader lease
        pending, message loss) are re-sent from tick() and expire after
        ~2 election timeouts."""
        from ..utils.failpoint import fail_point
        fail_point("read::before_replica_read")
        with self.mu:
            self._replica_read_ctx += 1
            ctx = self._replica_read_ctx
            self._replica_reads[ctx] = [cb, read_ts, 0]
            self.node.request_read_index(ctx, read_ts)

    def _serve_replica_reads(self) -> None:
        """Drain ReadIndex answers + reads unblocked by new applies."""
        node = self.node
        if node.read_states:
            states, node.read_states = node.read_states, []
            for index, ctx in states:
                ent = self._replica_reads.pop(ctx, None)
                if ent is not None:
                    self._replica_waiting.append((index, ent[0]))
        if not self._replica_waiting:
            return
        still = []
        for index, cb in self._replica_waiting:
            # the ReadIndex contract is "applied up to the leader's
            # commit point IN THE ENGINE"
            if self.applied_engine >= index:
                cb(self._snapshot(self.applied_engine))
            else:
                still.append((index, cb))
        self._replica_waiting = still

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
            wb = self.engine.write_batch()
            if rd.snapshot is not None:
                fail_point("snapshot::before_apply")
                region = self.peer_storage.apply_snapshot(wb, rd.snapshot)
                # a snapshot replaces all region data: stamp the data
                # version so columnar caches can never serve pre-snapshot
                # entries, and tell observers the data was replaced
                # WHOLESALE — committed-write delta logs cover nothing at
                # or before this index
                self.data_index = max(self.data_index,
                                      rd.snapshot.metadata.index)
                self.applied_engine = max(self.applied_engine,
                                          rd.snapshot.metadata.index)
                self._pending_obs.append(
                    (rd.snapshot.metadata.index, None))
                self.store.on_region_changed(self, region)
                fail_point("snapshot::after_apply")
            fail_point("raftlog::before_persist")
            meta = self.node.storage.snapshot.metadata
            self.peer_storage.persist(wb, rd.entries, rd.hard_state,
                                      truncated=(meta.index, meta.term))
            fail_point("apply::before_entries")
            cbs: list = []
            for entry in rd.committed_entries:
                if not wb.is_empty() and (
                        (not entry.data and
                         self._pending_read_at(entry.index, entry.term)) or
                        self._is_compute_hash(entry)):
                    # flush the applied prefix first: a read barrier's
                    # engine snapshot must include every earlier entry of
                    # this same ready batch, and ComputeHash digests the
                    # ENGINE state, which replicas batching differently
                    # must see at the same prefix (apply state rides along
                    # so a crash here never re-applies admin commands)
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
            if rd.committed_entries or rd.snapshot is not None:
                self.data_index_engine = self.data_index
                # observers run AFTER the engine write so they only ever
                # see durable state (coprocessor/mod.rs post-apply hooks)
                self._dispatch_obs()
            if rd.committed_entries:
                self.applied_engine = rd.committed_entries[-1].index
            # ACKs leave only now — after the engine write
            for prop, res in cbs:
                prop.cb(res)
            out.extend(rd.messages)
            self.node.advance(rd)
        self._serve_replica_reads()
        role = self.is_leader()
        if role != self._last_role:
            self._last_role = role
            if role and self.node.in_joint() and \
                    self.node._pending_conf_index <= self.node.applied:
                # the previous leader died between enter and leave: a
                # NEW leader re-proposes the bare leave or the cluster
                # stays joint forever (raft-rs auto transition)
                try:
                    self.node.propose_conf_change_v2(
                        ConfChangeV2((), b"", leave_joint=True),
                        force=True)
                except Exception:   # noqa: BLE001 — retried next ready
                    pass
            self.store.coprocessor_host.notify_role_change(
                self.region.id, role)
        return out

    @staticmethod
    def _is_compute_hash(entry) -> bool:
        if not entry.data or entry.entry_type is EntryType.CONF_CHANGE:
            return False
        return RaftCmd.peek_admin_kind(entry.data) == "compute_hash"

    def _dispatch_obs(self) -> None:
        """Flush applied-entry observer events, post-engine-write.
        ``ops is None`` marks a wholesale data replacement (snapshot
        apply) — delta subscribers must drop their coverage."""
        if not self._pending_obs:
            return
        host = self.store.coprocessor_host
        for index, ops in self._pending_obs:
            if ops is None:
                host.notify_data_replaced(self.region.id, index)
            else:
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
            if ConfChangeV2.is_v2(entry.data):
                cc2 = ConfChangeV2.from_bytes(entry.data)
                if cc2.context:
                    admin = RaftCmd.from_bytes(cc2.context).admin
                else:       # bare leave from a new leader
                    admin = AdminCmd("change_peer_v2")
                result = self._exec_change_peer_v2(wb, admin, cc2)
            else:
                cc = ConfChange.from_bytes(entry.data)
                cmd = RaftCmd.from_bytes(cc.context)
                result = self._exec_admin(wb, cmd.admin, cc=cc,
                                          index=entry.index)
        else:
            cmd = RaftCmd.from_bytes(entry.data)
            try:
                self._check_epoch_at_apply(cmd)
            except EpochNotMatch as e:
                if prop is not None:
                    out_cbs.append((prop, e))
                return
            if cmd.admin is not None:
                result = self._exec_admin(wb, cmd.admin,
                                          index=entry.index)
            else:
                # only actual KV mutations bump the data version: admin
                # commands leave table data untouched and splits bump
                # epoch.version, so the columnar cache key (which
                # includes both) stays exact without spurious
                # invalidation on log GC
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
        # size_diff_hint: written bytes accumulate until the split
        # checker consumes them (deletes count too — they change the
        # region's size estimate in the same direction the reference's
        # apply metrics do)
        for op in cmd.ops:
            self.size_diff_hint += len(op.key) + len(op.value)
        # bulk SST ingest (fsm/apply.rs IngestSst) lands its whole sorted
        # runs without passing the observers' per-key path
        exec_write_ops(wb, cmd.ops)
        return {}

    def _exec_admin(self, wb, admin: AdminCmd,
                    cc: Optional[ConfChange] = None,
                    index: int = 0) -> dict:
        from ..utils.failpoint import fail_point
        if admin.kind == "split":
            fail_point("apply::before_split")
            return self._exec_split(wb, admin)
        if admin.kind == "change_peer":
            fail_point("apply::before_conf_change")
            return self._exec_change_peer(wb, admin, cc)
        if admin.kind == "compact_log":
            fail_point("apply::before_compact_log")
            return self._exec_compact_log(wb, admin)
        if admin.kind == "prepare_merge":
            fail_point("apply::before_prepare_merge")
            return self._exec_prepare_merge(wb, admin, index)
        if admin.kind == "commit_merge":
            fail_point("apply::before_commit_merge")
            return self._exec_commit_merge(wb, admin)
        if admin.kind == "rollback_merge":
            return self._exec_rollback_merge(wb, admin)
        if admin.kind == "compute_hash":
            return self._exec_compute_hash(index, admin)
        if admin.kind == "verify_hash":
            return self._exec_verify_hash(admin)
        raise ValueError(f"admin command {admin.kind!r}")

    # -- consistency check (worker/consistency_check.rs + fsm/apply.rs
    #    exec_compute_hash/exec_verify_hash) --
    #
    # The leader proposes ComputeHash; EVERY replica, applying it at the
    # same log index over the same replicated data, computes an identical
    # digest of the region's data CFs.  The leader then proposes
    # VerifyHash(index, its own digest); a replica whose stored digest
    # for that index differs has diverged — the reference panics the
    # node, here InconsistentRegion surfaces through the drive loop.

    def _exec_compute_hash(self, index: int,
                           admin: Optional[AdminCmd] = None) -> dict:
        import zlib

        from ..storage.txn_types import split_ts
        # GC via each node's LOCAL compaction filter legitimately drops
        # versions at/below the safe point at node-local times — raw
        # bytes of two healthy replicas may differ below it.  The
        # leader pins its safe point into the proposal; every replica
        # hashes only versions ABOVE it, so the digest is deterministic
        # whether or not a replica has compacted yet.
        safe_point = 0
        if admin is not None and len(admin.extra) == 8:
            (safe_point,) = struct.unpack(">Q", admin.extra)
        lo, hi = region_data_bounds(self.region)
        crc = 0
        for cf in (CF_DEFAULT, CF_LOCK, CF_WRITE):
            crc = zlib.crc32(cf.encode(), crc)
            keys, vals, _skip = self.engine.range_cf(cf, lo, hi)
            pairs = zip(keys, vals)
            if safe_point and cf != CF_LOCK:
                pairs = ((k, v) for k, v in pairs
                         if len(k) <= 9 or split_ts(k[1:])[1] > safe_point)
            # the CRC of the pairs one after the other is the CRC of
            # their concatenation, in one call
            crc = zlib.crc32(b"".join(chain.from_iterable(pairs)), crc)
        # region state participates too (apply.rs hashes the region state
        # key): replicas at the same index must agree on the epoch
        ep = self.region.epoch
        crc = zlib.crc32(struct.pack(">QII", self.region.id, ep.conf_ver,
                                     ep.version), crc)
        self.consistency_state = (index, crc)
        return {"compute_hash": {"index": index, "hash": crc}}

    def _exec_verify_hash(self, admin: AdminCmd) -> dict:
        expect_index, expect_hash = struct.unpack(">QI", admin.extra)
        st = self.consistency_state
        if st is None or st[0] != expect_index:
            # stale/missed ComputeHash (e.g. this replica restarted or
            # caught up via snapshot past the compute index): the
            # reference logs and skips — a later round re-checks
            return {"verify_hash": "skipped"}
        if st[1] != expect_hash:
            raise InconsistentRegion(
                f"region {self.region.id} hash mismatch at index "
                f"{expect_index}: local {st[1]:#x} != leader "
                f"{expect_hash:#x}")
        return {"verify_hash": "ok"}

    def _exec_prepare_merge(self, wb, admin: AdminCmd,
                            index: int) -> dict:
        """fsm/apply.rs exec_prepare_merge: epoch bump + persisted merge
        state; the source stops accepting proposals until commit or
        rollback."""
        region = self.region
        new_region = replace(region, epoch=RegionEpoch(
            region.epoch.conf_ver, region.epoch.version + 1))
        self.peer_storage.persist_region(wb, new_region)
        wb.put_cf(CF_RAFT, merge_state_key(region.id),
                  index.to_bytes(8, "big"))
        self.merging = index
        self.store.on_region_changed(self, new_region)
        return {"region": new_region, "prepare_index": index}

    def _exec_rollback_merge(self, wb, admin: AdminCmd) -> dict:
        """fsm/apply.rs exec_rollback_merge: clear the merge state and
        bump the epoch so stale CommitMerge attempts epoch-fail."""
        region = self.region
        new_region = replace(region, epoch=RegionEpoch(
            region.epoch.conf_ver, region.epoch.version + 1))
        self.peer_storage.persist_region(wb, new_region)
        wb.delete_cf(CF_RAFT, merge_state_key(region.id))
        self.merging = None
        self.store.on_region_changed(self, new_region)
        return {"region": new_region}

    def _exec_commit_merge(self, wb, admin: AdminCmd) -> dict:
        """fsm/apply.rs exec_commit_merge (simplified to the coordinated
        protocol): the TARGET absorbs the adjacent source region.

        Data never moves — both regions share this store's engine; only
        the region boundary and the source's raft-local state change.
        Safety precondition (the coordinator enforced it before
        proposing, ``Node.merge_region`` / ``Cluster.merge_region``):
        every source peer has applied the PrepareMerge, so the local
        source peer's data is complete up to the merge point.  The
        reference instead ships the source log tail inside CommitMerge —
        the coordinated wait is the in-process equivalent.
        """
        source = decode_region(admin.extra)
        region = self.region
        speer = self.store.peers.get(source.id)
        if speer is not None:
            # drain any committed-but-unapplied source entries first
            # (messages are dropped; the group is being destroyed)
            if speer.node.applied < admin.merge_index:
                speer.handle_ready()
            if speer.node.applied < admin.merge_index:
                raise AssertionError(
                    f"commit_merge: source {source.id} applied "
                    f"{speer.node.applied} < prepare {admin.merge_index}")
        # b"" as end_key means +infinity — it must never compare equal
        # to a b"" start_key (-infinity)
        if source.end_key and source.end_key == region.start_key:
            new_start, new_end = source.start_key, region.end_key
        elif region.end_key and region.end_key == source.start_key:
            new_start, new_end = region.start_key, source.end_key
        else:
            raise AssertionError("commit_merge: regions not adjacent")
        new_region = replace(
            region, start_key=new_start, end_key=new_end,
            epoch=RegionEpoch(
                max(region.epoch.conf_ver, source.epoch.conf_ver),
                max(region.epoch.version, source.epoch.version) + 1))
        self.peer_storage.persist_region(wb, new_region)
        self.store.destroy_peer(source.id)
        self.store.on_region_changed(self, new_region)
        return {"region": new_region}

    def _exec_split(self, wb, admin: AdminCmd) -> dict:
        """fsm/apply.rs exec_batch_split: left keeps the id, right is the
        new region [split_key, end); both bump epoch.version."""
        region = self.region
        new_epoch = RegionEpoch(region.epoch.conf_ver,
                                region.epoch.version + 1)
        right_peers = tuple(
            PeerMeta(pid, p.store_id, p.is_learner)
            for pid, p in zip(admin.new_peer_ids, region.peers))
        right = Region(admin.new_region_id, admin.split_key,
                       region.end_key, new_epoch, right_peers)
        left = replace(region, end_key=admin.split_key, epoch=new_epoch)
        self.peer_storage.persist_region(wb, left)
        self.store.create_split_peer(wb, right, was_leader=self.is_leader())
        # split-aware observers (delta-log carry-over, device-side
        # line/feed slicing) act BEFORE the generic region_changed
        # sweep tears the parent's cache lines down.  Admin entries
        # never bump data_index, so self.data_index IS the last
        # pre-split write — the exact stamp for both children
        right_peer = self.store.peers.get(right.id)
        self.store.coprocessor_host.notify_region_split(
            left, right, self.data_index,
            right_peer.data_index if right_peer is not None else None)
        self.store.on_region_changed(self, left)
        return {"left": left, "right": right}

    def _exec_change_peer(self, wb, admin: AdminCmd,
                          cc: Optional[ConfChange]) -> dict:
        region = self.region
        peers = list(region.peers)
        p = admin.peer
        peers = [x for x in peers if x.id != p.id]
        if admin.change_type in ("add", "add_learner"):
            peers.append(PeerMeta(p.id, p.store_id,
                                  admin.change_type == "add_learner"))
        new_region = region.with_peers(peers)
        self.peer_storage.persist_region(wb, new_region)
        if cc is not None:
            self.node.apply_conf_change(cc)
        self.store.on_region_changed(self, new_region)
        if admin.change_type == "remove" and p.id == self.meta.id:
            self.pending_destroy = True
        return {"region": new_region}

    def _exec_change_peer_v2(self, wb, admin: AdminCmd, cc2) -> dict:
        """Joint membership change apply (fsm/apply.rs ChangePeerV2 +
        raft §6).  Enter: region carries the UNION of old and new peer
        sets while raft enforces both majorities; the leader then
        auto-proposes the LEAVE, whose apply installs the target set.
        """
        meta = decode_change_peer_v2(admin.extra) if admin.extra else \
            {"changes": [], "leave": True, "target": None}
        region = self.region
        node = self.node
        node.apply_conf_change_v2(cc2)
        # persist the joint state (BOTH sets: the incoming voters can't
        # be derived from region.peers, which holds the union) so a
        # restart mid-joint keeps the both-majority rules
        if node.voters_outgoing:
            out_s = sorted(node.voters_outgoing)
            in_s = sorted(node.voters)
            wb.put_cf(CF_RAFT, joint_state_key(region.id),
                      struct.pack(">II", len(out_s), len(in_s)) +
                      b"".join(struct.pack(">Q", v)
                               for v in out_s + in_s))
        else:
            wb.delete_cf(CF_RAFT, joint_state_key(region.id))
        if cc2.leave_joint:
            if meta.get("target"):
                target = tuple(PeerMeta(p["id"], p["store_id"],
                                        p.get("learner", False))
                               for p in meta["target"])
            else:
                # bare leave (new-leader re-proposal): the target is the
                # post-leave raft membership filtered from the union
                member = node.voters | node.learners
                target = tuple(p for p in region.peers
                               if p.id in member)
            new_region = replace(
                region, peers=target,
                epoch=RegionEpoch(region.epoch.conf_ver + 1,
                                  region.epoch.version))
            self.peer_storage.persist_region(wb, new_region)
            self.store.on_region_changed(self, new_region)
            if not any(p.id == self.meta.id for p in target):
                self.pending_destroy = True
            return {"region": new_region}
        # enter joint: union of old peers and the incoming changes
        peers = {p.id: p for p in region.peers}
        target = dict(peers)
        for c in meta["changes"]:
            p = c["peer"]
            pm = PeerMeta(p["id"], p["store_id"], c["t"] == "add_learner")
            if c["t"] == "remove":
                target.pop(p["id"], None)
            else:
                target[p["id"]] = pm
                peers[p["id"]] = pm
        new_region = replace(
            region, peers=tuple(peers.values()),
            epoch=RegionEpoch(region.epoch.conf_ver + 1,
                              region.epoch.version))
        self.peer_storage.persist_region(wb, new_region)
        self.store.on_region_changed(self, new_region)
        if self.is_leader():
            # auto-leave (raft-rs ConfChangeV2 auto transition): the
            # leave entry carries the TARGET peer set for the meta
            leave_cmd = RaftCmd(
                new_region.id, new_region.epoch,
                admin=AdminCmd("change_peer_v2",
                               extra=encode_change_peer_v2(
                                   leave=True,
                                   target=list(target.values()))))
            node.propose_conf_change_v2(
                ConfChangeV2((), leave_cmd.to_bytes(), leave_joint=True),
                force=True)
        return {"region": new_region, "joint": True}

    def _exec_compact_log(self, wb, admin: AdminCmd) -> dict:
        index = min(admin.compact_index, self.node.applied)
        if index > self.node.storage.snapshot.metadata.index:
            self.node.storage.compact(index)
            self.peer_storage.compact_log(wb, index)
            # Rewrite raft_state with the POST-compact truncated marker in
            # the same batch: handle_ready persisted it with the marker
            # captured before this apply, and a crash between the two
            # writes would leave trunc_idx pointing below log entries that
            # this batch just deleted — an unrecoverable, non-contiguous
            # log on restart (reference: fsm/apply.rs exec_compact_log
            # updates RaftTruncatedState atomically with the deletion).
            meta = self.node.storage.snapshot.metadata
            self.peer_storage.persist(
                wb, [],
                HardState(self.node.term, self.node.vote, self.node.commit),
                truncated=(meta.index, meta.term))
        return {}

    # ------------------------------------------------------------- misc

    def _make_snapshot(self, index: int, term: int):
        # Generate at the APPLIED index, not the compaction marker: the
        # engine data + region meta reflect exactly node.applied, and a
        # lower stamp would make the receiver re-apply entries (e.g. conf
        # changes double-bumping conf_ver).  Reference: peer_storage.rs
        # do_snapshot uses the apply state's applied_index.
        from ..utils.failpoint import fail_point
        fail_point("snapshot::before_generate")
        node = self.node
        applied = node.applied
        t = node.storage.term(applied)
        if t is None:
            t = term
        # raft-level conf travels verbatim: while JOINT, a receiver
        # must apply both-majority rules — deriving voters from the
        # region's peer union would weaken elections to a single
        # union-majority (unsafe: {old majority} can outvote there)
        conf = (sorted(node.voters), sorted(node.learners),
                sorted(node.voters_outgoing))
        return self.peer_storage.generate_snapshot(applied, t,
                                                   self.region, conf)

    def step(self, msg: Message) -> None:
        self.node.step(msg)

    def tick(self) -> None:
        self.node.tick()
        if self._replica_reads:
            self._retry_replica_reads()

    def _retry_replica_reads(self) -> None:
        """Re-send pending ReadIndex requests (dropped request, leader
        without a lease yet, election churn) and expire hopeless ones."""
        expire_at = 4 * self.node._election_tick
        dead = []
        for ctx, ent in self._replica_reads.items():
            ent[2] += 1
            if ent[2] >= expire_at:
                dead.append(ctx)
            elif ent[2] % 2 == 0:
                self.node.request_read_index(ctx, ent[1])
        for ctx in dead:
            cb, _ts, _age = self._replica_reads.pop(ctx)
            cb(NotLeaderError(self.region.id, self.leader_peer()))
