"""Raft consensus.

A copy of the JAX package's ``raft package``.

The reference consumes the external ``raft-rs`` crate (Cargo.toml:219);
the rebuild provides the capability natively: a deterministic, tick-driven
Raft state machine with the RawNode/Ready interface raftstore expects
(SURVEY.md §2.1 "architecturally load-bearing" external crates).
"""

from .messages import (
    ConfChange,
    ConfChangeType,
    Entry,
    EntryType,
    HardState,
    Message,
    MsgType,
    Snapshot,
    SnapshotMetadata,
)
from .raw_node import RawNode, Ready
from .storage import MemoryRaftStorage

__all__ = [
    "ConfChange", "ConfChangeType", "Entry", "EntryType", "HardState",
    "Message", "MsgType", "Snapshot", "SnapshotMetadata",
    "RawNode", "Ready", "MemoryRaftStorage",
]
