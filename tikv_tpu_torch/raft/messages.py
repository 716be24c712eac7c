"""Raft wire types.

A copy of the JAX package's ``raft/messages.py``.

Reference: the eraftpb protobuf consumed by raft-rs (Entry, Message,
HardState, Snapshot, ConfChange) — plain dataclasses here; the transport
layer owns serialization.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum, auto
from typing import Optional


class EntryType(Enum):
    NORMAL = auto()
    CONF_CHANGE = auto()


@dataclass(frozen=True)
class Entry:
    term: int
    index: int
    data: bytes = b""
    entry_type: EntryType = EntryType.NORMAL


class ConfChangeType(Enum):
    ADD_NODE = auto()
    REMOVE_NODE = auto()
    ADD_LEARNER = auto()


@dataclass(frozen=True)
class ConfChange:
    change_type: ConfChangeType
    node_id: int
    context: bytes = b""

    def to_bytes(self) -> bytes:
        return b"%d:%d:%s" % (self.change_type.value, self.node_id,
                              self.context)

    @staticmethod
    def from_bytes(b: bytes) -> "ConfChange":
        t, n, ctx = b.split(b":", 2)
        return ConfChange(ConfChangeType(int(t)), int(n), ctx)


@dataclass(frozen=True)
class ConfChangeV2:
    """Joint-consensus membership change (raft §6 / raft-rs
    ConfChangeV2): several changes enter ATOMICALLY via the joint
    config C_old,new — commits and elections need majorities of BOTH
    sets until the leave entry retires C_old.

    Wire format: ``2|<leave>|t:n,t:n,...|context`` — the leading "2|"
    disambiguates from the V1 "<type>:<id>:<ctx>" format in the shared
    CONF_CHANGE entry type.
    """

    changes: tuple = ()         # tuple[(ConfChangeType, node_id)]
    context: bytes = b""
    leave_joint: bool = False

    def to_bytes(self) -> bytes:
        body = b",".join(b"%d:%d" % (t.value, n)
                         for t, n in self.changes)
        return b"2|%d|%s|%s" % (int(self.leave_joint), body,
                                self.context)

    @staticmethod
    def is_v2(data: bytes) -> bool:
        return data.startswith(b"2|")

    @staticmethod
    def from_bytes(b: bytes) -> "ConfChangeV2":
        _tag, leave, body, ctx = b.split(b"|", 3)
        changes = []
        if body:
            for part in body.split(b","):
                t, n = part.split(b":")
                changes.append((ConfChangeType(int(t)), int(n)))
        return ConfChangeV2(tuple(changes), ctx, bool(int(leave)))


@dataclass
class HardState:
    """Durable before any message send (raft paper §5)."""

    term: int = 0
    vote: int = 0
    commit: int = 0


@dataclass(frozen=True)
class SnapshotMetadata:
    index: int
    term: int
    voters: tuple = ()
    learners: tuple = ()
    # non-empty while the config is joint (C_old half of C_old,new)
    voters_outgoing: tuple = ()


@dataclass(frozen=True)
class Snapshot:
    metadata: SnapshotMetadata
    data: bytes = b""


class MsgType(Enum):
    HUP = auto()                # local: start election
    BEAT = auto()               # local: leader heartbeat tick
    PROPOSE = auto()            # local: client proposal
    APPEND = auto()
    APPEND_RESPONSE = auto()
    REQUEST_VOTE = auto()
    REQUEST_VOTE_RESPONSE = auto()
    PRE_VOTE = auto()
    PRE_VOTE_RESPONSE = auto()
    HEARTBEAT = auto()
    HEARTBEAT_RESPONSE = auto()
    SNAPSHOT = auto()
    TRANSFER_LEADER = auto()    # local: admin transfer
    TIMEOUT_NOW = auto()
    # follower/replica reads (raft §6.4 ReadIndex): a follower asks the
    # leader for its commit index; serving waits until applied >= it
    READ_INDEX = auto()
    READ_INDEX_RESP = auto()


@dataclass
class Message:
    msg_type: MsgType
    to: int = 0
    frm: int = 0
    term: int = 0
    # append/vote payloads
    log_term: int = 0           # term of entry at ``index``
    index: int = 0              # prev log index (append) / last index (vote)
    entries: tuple = ()
    commit: int = 0
    reject: bool = False
    reject_hint: int = 0        # follower's last index, speeds backtracking
    snapshot: Optional[Snapshot] = None
    # lease context: leaders stamp heartbeats with their send tick; the
    # response echoes it so the lease window is measured from SEND time
    # (reference: raftstore leader lease, store/peer.rs maybe_renew_lease).
    # None = no lease context — distinct from tick 0, which is a valid ack
    ctx: Optional[int] = None
