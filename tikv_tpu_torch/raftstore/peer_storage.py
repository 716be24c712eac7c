"""Peer storage — durable raft state in the engine.

A copy of the JAX package's ``raftstore/peer_storage.py``: the region raft
key layout, the entry and region codecs, the load and persist of one
peer's raft state (its joint-consensus and merge state keys included),
log compaction, peer destruction, and the region snapshots a leader
generates for a lagging or new follower and the follower applies.

Reference: components/raftstore/src/store/peer_storage.rs (RaftLocalState,
RaftApplyState, RegionLocalState persisted in CF_RAFT) and
components/keys/src/lib.rs (region raft key layout).  The RawNode runs on
an in-memory log (raft/storage.py); this class mirrors every persisted
Ready into the engine so a restarted store reconstructs the exact raft
state, and generates region snapshots for follower catch-up.
"""

from __future__ import annotations

import struct
from itertools import chain
from typing import Optional, Sequence

import numpy as np

# data_key is re-exported: callers import it from here, as from the JAX
# package's peer_storage
from ..codec.keys import DATA_PREFIX, data_key  # noqa: F401
from ..engine.traits import CF_RAFT, DATA_CFS, KvEngine
from ..raft.messages import (
    Entry,
    EntryType,
    HardState,
    Snapshot,
    SnapshotMetadata,
)
from ..raft.storage import MemoryRaftStorage
from .cmd import _pack_bytes, _unpack_bytes
from .metapb import Peer, Region, RegionEpoch

LOCAL_PREFIX = b"\x01"
REGION_PREFIX = LOCAL_PREFIX + b"r"

# New regions start their log *after* this index (reference:
# store/peer_storage.rs RAFT_INIT_LOG_INDEX/TERM = 5).  An empty shell
# peer (created on first message) can then never be served by log
# appends — the leader must ship a region snapshot, which carries the
# authoritative region metadata.  Catch-up via bare log replay would
# leave the shell's peer list permanently diverged.
RAFT_INIT_LOG_INDEX = 5
RAFT_INIT_LOG_TERM = 5


def raft_log_key(region_id: int, index: int) -> bytes:
    return REGION_PREFIX + struct.pack(">Q", region_id) + b"l" + \
        struct.pack(">Q", index)


def raft_state_key(region_id: int) -> bytes:
    return REGION_PREFIX + struct.pack(">Q", region_id) + b"s"


def apply_state_key(region_id: int) -> bytes:
    return REGION_PREFIX + struct.pack(">Q", region_id) + b"a"


def region_state_key(region_id: int) -> bytes:
    return REGION_PREFIX + struct.pack(">Q", region_id) + b"m"


def joint_state_key(region_id: int) -> bytes:
    """Persisted joint-consensus outgoing voter set (ConfState's
    voters_outgoing): non-empty between enter-joint and leave-joint so
    a restarted peer keeps enforcing BOTH majorities."""
    return REGION_PREFIX + struct.pack(">Q", region_id) + b"j"


def merge_state_key(region_id: int) -> bytes:
    """Persisted PrepareMerge state (raft_serverpb MergeState analog):
    value = >Q prepare-apply-index.  Lives under the region's CF_RAFT
    prefix so peer destruction cleans it up with everything else."""
    return REGION_PREFIX + struct.pack(">Q", region_id) + b"g"


def region_data_bounds(region: Region) -> tuple[bytes, Optional[bytes]]:
    lower = DATA_PREFIX + region.start_key
    upper = DATA_PREFIX + region.end_key if region.end_key else \
        bytes([DATA_PREFIX[0] + 1])
    return lower, upper


# -- serialization of the three local states --

def encode_region(region: Region) -> bytes:
    out = struct.pack(">QII", region.id, region.epoch.conf_ver,
                      region.epoch.version)
    out += _pack_bytes(region.start_key) + _pack_bytes(region.end_key)
    out += struct.pack(">I", len(region.peers))
    for p in region.peers:
        out += struct.pack(">QQB", p.id, p.store_id, int(p.is_learner))
    return out


def decode_region(buf: bytes) -> Region:
    rid, conf_ver, version = struct.unpack_from(">QII", buf, 0)
    off = 16
    start, off = _unpack_bytes(buf, off)
    end, off = _unpack_bytes(buf, off)
    (n,) = struct.unpack_from(">I", buf, off)
    off += 4
    peers = []
    for _ in range(n):
        pid, sid, learner = struct.unpack_from(">QQB", buf, off)
        off += 17
        peers.append(Peer(pid, sid, bool(learner)))
    return Region(rid, start, end, RegionEpoch(conf_ver, version),
                  tuple(peers))


def _lengths(items: list) -> list:
    """Each item's length as the 4-byte big-endian prefix of
    ``_pack_bytes``."""
    raw = np.fromiter(map(len, items), np.dtype(">u4"), len(items)).tobytes()
    return [raw[i:i + 4] for i in range(0, len(raw), 4)]


def encode_entry(e: Entry) -> bytes:
    return struct.pack(">QQB", e.term, e.index,
                       1 if e.entry_type is EntryType.CONF_CHANGE else 0) \
        + e.data


def decode_entry(buf: bytes) -> Entry:
    term, index, is_cc = struct.unpack_from(">QQB", buf, 0)
    return Entry(term, index, buf[17:],
                 EntryType.CONF_CHANGE if is_cc else EntryType.NORMAL)


class PeerRaftStorage(MemoryRaftStorage):
    """MemoryRaftStorage whose *outgoing* snapshots are generated on
    demand from region data (leader side of follower catch-up); the
    compaction marker ``self.snapshot`` stays the log-arithmetic anchor."""

    def __init__(self, voters: Sequence[int] = ()):
        super().__init__(voters)
        self.snapshot_provider = None   # fn(index, term) -> Snapshot

    def snapshot_for_send(self):
        if self.snapshot_provider is not None:
            meta = self.snapshot.metadata
            return self.snapshot_provider(meta.index, meta.term)
        return self.snapshot


class PeerStorage:
    """Durability mirror of one peer's raft state."""

    def __init__(self, engine: KvEngine, region: Region):
        self.engine = engine
        self.region = region

    # -- restart/load --

    def load(self) -> tuple[PeerRaftStorage, int]:
        """→ (raft storage for RawNode, applied_index)."""
        rid = self.region.id
        ms = PeerRaftStorage(voters=tuple(
            p.id for p in self.region.peers if not p.is_learner))
        outgoing: tuple = ()
        incoming = None
        rawj = self.engine.get_value_cf(CF_RAFT, joint_state_key(rid))
        if rawj:
            n_out, n_in = struct.unpack_from(">II", rawj, 0)
            vals = struct.unpack_from(f">{n_out + n_in}Q", rawj, 8)
            outgoing = tuple(vals[:n_out])
            # the true INCOMING set: region.peers holds the old/new
            # UNION while joint, so deriving voters from it would
            # weaken decisions to a union majority
            incoming = tuple(vals[n_out:])
        ms.set_conf(
            incoming if incoming is not None else
            [p.id for p in self.region.peers if not p.is_learner],
            [p.id for p in self.region.peers if p.is_learner],
            outgoing)
        raw = self.engine.get_value_cf(CF_RAFT, raft_state_key(rid))
        applied = 0
        if raw is not None:
            term, vote, commit, trunc_idx, trunc_term = \
                struct.unpack_from(">QQQQQ", raw, 0)
            ms.set_hard_state(HardState(term, vote, commit))
            if trunc_idx:
                meta = ms.snapshot.metadata
                ms.snapshot = Snapshot(SnapshotMetadata(
                    trunc_idx, trunc_term, meta.voters, meta.learners,
                    meta.voters_outgoing))
            # replay the persisted log tail
            it = self.engine.iterator_cf(
                CF_RAFT, raft_log_key(rid, 0),
                raft_log_key(rid, 2**64 - 1))
            ok = it.seek_to_first()
            entries = []
            while ok:
                entries.append(decode_entry(it.value()))
                ok = it.next()
            if entries:
                ms.append(entries)
        rawa = self.engine.get_value_cf(CF_RAFT, apply_state_key(rid))
        if rawa is not None:
            (applied,) = struct.unpack_from(">Q", rawa, 0)
        return ms, applied

    # -- persist one Ready --

    def persist(self, wb, entries: Sequence[Entry],
                hard_state: Optional[HardState],
                truncated: tuple = (0, 0)) -> None:
        rid = self.region.id
        for e in entries:
            wb.put_cf(CF_RAFT, raft_log_key(rid, e.index), encode_entry(e))
        if entries:
            # drop any stale conflicting suffix beyond the new last entry
            wb.delete_range_cf(CF_RAFT,
                               raft_log_key(rid, entries[-1].index + 1),
                               raft_log_key(rid, 2**64 - 1))
        if hard_state is not None:
            wb.put_cf(CF_RAFT, raft_state_key(rid), struct.pack(
                ">QQQQQ", hard_state.term, hard_state.vote,
                hard_state.commit, truncated[0], truncated[1]))

    def write_initial_state(self, wb) -> None:
        """Bootstrap/split-time state: log begins at RAFT_INIT_LOG_INDEX."""
        rid = self.region.id
        wb.put_cf(CF_RAFT, raft_state_key(rid), struct.pack(
            ">QQQQQ", RAFT_INIT_LOG_TERM, 0, RAFT_INIT_LOG_INDEX,
            RAFT_INIT_LOG_INDEX, RAFT_INIT_LOG_TERM))
        self.persist_apply(wb, RAFT_INIT_LOG_INDEX)

    def persist_apply(self, wb, applied_index: int) -> None:
        wb.put_cf(CF_RAFT, apply_state_key(self.region.id),
                  struct.pack(">Q", applied_index))

    def persist_region(self, wb, region: Region) -> None:
        self.region = region
        wb.put_cf(CF_RAFT, region_state_key(region.id),
                  encode_region(region))

    def compact_log(self, wb, to_index: int) -> None:
        rid = self.region.id
        wb.delete_range_cf(CF_RAFT, raft_log_key(rid, 0),
                           raft_log_key(rid, to_index + 1))

    def destroy(self, wb) -> None:
        rid = self.region.id
        wb.delete_range_cf(CF_RAFT, REGION_PREFIX + struct.pack(">Q", rid),
                           REGION_PREFIX + struct.pack(">Q", rid + 1))

    # -- region snapshots (follower catch-up; store/snap.rs role) --

    def generate_snapshot(self, index: int, term: int,
                          region: Region, conf=None) -> Snapshot:
        snap = self.engine.snapshot()
        lower, upper = region_data_bounds(region)
        parts = [encode_region(region)]
        for cf in DATA_CFS:
            # one bulk range read; every (length, key, length, value)
            # joined at once — the region of a chip cell holds 10^6 keys
            keys, vals, _skip = snap.range_cf(cf, lower, upper)
            parts.append(_pack_bytes(cf.encode()) +
                         struct.pack(">I", len(keys)) +
                         b"".join(chain.from_iterable(zip(
                             _lengths(keys), keys, _lengths(vals), vals))))
        if conf is not None:
            voters, learners, outgoing = conf
        else:
            voters = tuple(p.id for p in region.peers
                           if not p.is_learner)
            learners = tuple(p.id for p in region.peers if p.is_learner)
            outgoing = ()
        return Snapshot(SnapshotMetadata(index, term, tuple(voters),
                                         tuple(learners),
                                         tuple(outgoing)),
                        _pack_bytes(parts[0]) + b"".join(parts[1:]))

    def apply_snapshot(self, wb, snap: Snapshot) -> Region:
        """Install region data from a snapshot; returns the region meta."""
        buf = snap.data
        region_raw, off = _unpack_bytes(buf, 0)
        region = decode_region(region_raw)
        # Clear ALL persisted raft log entries for the region: a lagging
        # follower caught up by snapshot may hold stale entries below the
        # snapshot index, which restart-replay would then try to append
        # under the new (higher) compaction marker and assert.  Entries
        # after the snapshot are re-persisted by subsequent readies.
        # (reference: peer_storage.rs clear_meta deletes the raft log
        # range when applying a snapshot)
        wb.delete_range_cf(CF_RAFT, raft_log_key(region.id, 0),
                           raft_log_key(region.id, 2**64 - 1))
        lower, upper = region_data_bounds(region)
        for cf in DATA_CFS:
            wb.delete_range_cf(cf, lower, upper)
        for _ in range(len(DATA_CFS)):
            cf_raw, off = _unpack_bytes(buf, off)
            cf = cf_raw.decode()
            (n,) = struct.unpack_from(">I", buf, off)
            off += 4
            keys, vals = [], []
            for _ in range(n):
                k, off = _unpack_bytes(buf, off)
                v, off = _unpack_bytes(buf, off)
                keys.append(k)
                vals.append(v)
            # the pairs are one sorted run inside the range just cleared
            wb.ingest_cf(cf, keys, vals)
        self.persist_region(wb, region)
        self.persist_apply(wb, snap.metadata.index)
        # a mid-joint snapshot must leave the receiver JOINT across a
        # restart too: persist both voter sets, or clear (restore()
        # would otherwise derive a single union config from the peers —
        # the split-brain generate_snapshot's comment warns about)
        meta = snap.metadata
        outgoing = tuple(getattr(meta, "voters_outgoing", ()))
        if outgoing:
            out_s, in_s = sorted(outgoing), sorted(meta.voters)
            wb.put_cf(CF_RAFT, joint_state_key(region.id),
                      struct.pack(">II", len(out_s), len(in_s)) +
                      b"".join(struct.pack(">Q", v)
                               for v in out_s + in_s))
        else:
            wb.delete_cf(CF_RAFT, joint_state_key(region.id))
        return region
