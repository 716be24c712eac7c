"""Raft log storage.

A copy of the JAX package's ``raft/storage.py``.

Reference: raft-rs's ``Storage`` trait + MemoryStorage; the raftstore
layer implements it over the engine (PeerStorage,
components/raftstore/src/store/peer_storage.rs) — same split here.

Index convention (raft-rs): the log logically starts after a snapshot;
``first_index`` is snapshot_index + 1; entry 0/term 0 is the origin.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .messages import Entry, HardState, Snapshot, SnapshotMetadata


class MemoryRaftStorage:
    def __init__(self, voters: Sequence[int] = ()):
        self.hard_state = HardState()
        self.snapshot = Snapshot(SnapshotMetadata(0, 0, tuple(voters)))
        self.entries: list[Entry] = []      # contiguous after snapshot

    # -- raft-rs Storage trait --

    def initial_state(self) -> tuple[HardState, tuple, tuple]:
        meta = self.snapshot.metadata
        return self.hard_state, meta.voters, meta.learners

    def initial_outgoing(self) -> tuple:
        return getattr(self.snapshot.metadata, "voters_outgoing", ())

    def first_index(self) -> int:
        return self.snapshot.metadata.index + 1

    def last_index(self) -> int:
        if self.entries:
            return self.entries[-1].index
        return self.snapshot.metadata.index

    def term(self, index: int) -> Optional[int]:
        meta = self.snapshot.metadata
        if index == meta.index:
            return meta.term
        if index < meta.index:
            return None     # compacted
        i = index - meta.index - 1
        if i >= len(self.entries):
            return None
        return self.entries[i].term

    def slice(self, lo: int, hi: int) -> list[Entry]:
        """Entries [lo, hi); lo must be >= first_index."""
        base = self.snapshot.metadata.index + 1
        assert lo >= base, (lo, base)
        return self.entries[lo - base:hi - base]

    # -- mutation (called when persisting a Ready) --

    def append(self, entries: Sequence[Entry]) -> None:
        if not entries:
            return
        base = self.snapshot.metadata.index + 1
        first_new = entries[0].index
        assert first_new >= base, "appending compacted entries"
        # truncate conflicting suffix, then extend
        self.entries = self.entries[:first_new - base] + list(entries)

    def set_hard_state(self, hs: HardState) -> None:
        self.hard_state = HardState(hs.term, hs.vote, hs.commit)

    def apply_snapshot(self, snap: Snapshot) -> None:
        assert snap.metadata.index >= self.snapshot.metadata.index
        self.snapshot = snap
        self.entries = []
        self.hard_state.commit = max(self.hard_state.commit,
                                     snap.metadata.index)

    def compact(self, index: int) -> None:
        """Drop entries up to ``index`` (inclusive), folding them into the
        snapshot marker (log GC; raftstore's raftlog_gc worker)."""
        meta = self.snapshot.metadata
        if index <= meta.index:
            return
        term = self.term(index)
        assert term is not None, "compacting beyond last index"
        base = meta.index + 1
        self.entries = self.entries[index - base + 1:]
        self.snapshot = Snapshot(
            SnapshotMetadata(index, term, meta.voters, meta.learners),
            self.snapshot.data)

    def snapshot_for_send(self) -> Snapshot:
        """Snapshot to ship to a lagging follower.  Subclasses may
        generate region data on demand (raftstore PeerStorage); metadata
        must match ``self.snapshot.metadata`` (the log arithmetic anchor).
        """
        return self.snapshot

    def set_conf(self, voters: Sequence[int],
                 learners: Sequence[int] = (),
                 voters_outgoing: Sequence[int] = ()) -> None:
        meta = self.snapshot.metadata
        self.snapshot = Snapshot(
            SnapshotMetadata(meta.index, meta.term, tuple(voters),
                             tuple(learners), tuple(voters_outgoing)),
            self.snapshot.data)
