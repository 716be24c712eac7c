"""Peer storage — durable raft state in the engine.

A trimmed copy of the JAX package's ``raftstore/peer_storage.py``: the
region raft key layout, the entry and region codecs, and the load and
persist of one peer's raft state.  A single store neither sends nor
receives region snapshots and never enters joint consensus, so the
snapshot generate/apply pair and the joint and merge state keys are left
out.

Reference: components/raftstore/src/store/peer_storage.rs (RaftLocalState,
RaftApplyState, RegionLocalState persisted in CF_RAFT) and
components/keys/src/lib.rs (region raft key layout).  The RawNode runs on
an in-memory log (raft/storage.py); this class mirrors every persisted
Ready into the engine so a restarted store reconstructs the exact raft
state.
"""

from __future__ import annotations

import struct
from typing import Optional, Sequence

from ..codec.keys import DATA_PREFIX
from ..engine.traits import CF_RAFT, KvEngine
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
# store/peer_storage.rs RAFT_INIT_LOG_INDEX/TERM = 5).
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


def region_data_bounds(region: Region) -> tuple[bytes, Optional[bytes]]:
    """The region's [lower, upper) in the engine's data-key space."""
    lower = DATA_PREFIX + region.start_key
    upper = DATA_PREFIX + region.end_key if region.end_key else \
        bytes([DATA_PREFIX[0] + 1])
    return lower, upper


# -- serialization of the local states --

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


def encode_entry(e: Entry) -> bytes:
    return struct.pack(">QQB", e.term, e.index,
                       1 if e.entry_type is EntryType.CONF_CHANGE else 0) \
        + e.data


def decode_entry(buf: bytes) -> Entry:
    term, index, is_cc = struct.unpack_from(">QQB", buf, 0)
    return Entry(term, index, buf[17:],
                 EntryType.CONF_CHANGE if is_cc else EntryType.NORMAL)


class PeerStorage:
    """Durability mirror of one peer's raft state."""

    def __init__(self, engine: KvEngine, region: Region):
        self.engine = engine
        self.region = region

    # -- restart/load --

    def load(self) -> tuple[MemoryRaftStorage, int]:
        """→ (raft storage for RawNode, applied_index)."""
        rid = self.region.id
        ms = MemoryRaftStorage(voters=tuple(
            p.id for p in self.region.peers if not p.is_learner))
        ms.set_conf(
            [p.id for p in self.region.peers if not p.is_learner],
            [p.id for p in self.region.peers if p.is_learner], ())
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
        """Bootstrap-time state: log begins at RAFT_INIT_LOG_INDEX."""
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
