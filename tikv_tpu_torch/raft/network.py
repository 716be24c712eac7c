"""In-process raft network harness — deterministic message routing with
fault injection.

A copy of the JAX package's ``raft/network.py``.

Reference: raft-rs's test Network + the message-level fault injection of
components/test_raftstore/src/transport_simulate.rs (drop/delay/partition
filters) — the fixture style SURVEY.md §4 calls out as load-bearing.
"""

from __future__ import annotations

import random

from typing import Callable, Optional, Sequence

from ..utils.failpoint import fail_point
from .messages import Message
from .raw_node import RawNode, Ready
from .storage import MemoryRaftStorage


class RaftNetwork:
    def __init__(self, ids: Sequence[int], election_tick: int = 10,
                 heartbeat_tick: int = 2, pre_vote: bool = True,
                 seed: int = 0):
        self.nodes: dict[int, RawNode] = {}
        self.applied: dict[int, list] = {}
        self.installed_snapshots: dict[int, int] = {}
        # filters: fn(msg) -> bool (True = deliver); reference:
        # transport_simulate.rs Filter trait
        self.filters: list[Callable[[Message], bool]] = []
        self._inbox: list[Message] = []
        # deterministic source for failpoint-driven reorder/duplicate
        self._chaos_rng = random.Random(seed)
        for nid in ids:
            storage = MemoryRaftStorage(voters=tuple(ids))
            self.nodes[nid] = RawNode(nid, storage, election_tick,
                                      heartbeat_tick, pre_vote, seed)
            self.applied[nid] = []

    # -- fault injection --

    def partition(self, group_a: Sequence[int], group_b: Sequence[int]):
        a, b = set(group_a), set(group_b)

        def filt(m: Message) -> bool:
            return not ((m.frm in a and m.to in b) or
                        (m.frm in b and m.to in a))
        self.filters.append(filt)
        return filt

    def isolate(self, nid: int):
        def filt(m: Message) -> bool:
            return m.frm != nid and m.to != nid
        self.filters.append(filt)
        return filt

    def heal(self, filt=None) -> None:
        if filt is None:
            self.filters.clear()
        else:
            self.filters.remove(filt)

    # -- pump --

    def _drain_node(self, nid: int) -> None:
        node = self.nodes[nid]
        while node.has_ready():
            rd = node.ready()
            for e in rd.committed_entries:
                self._apply(nid, e)
            for m in rd.messages:
                if not all(f(m) for f in self.filters):
                    continue
                # message-level fault sites (transport_simulate.rs
                # DropPacket/Delay/OutOfOrder filters as failpoints):
                # a fired "return" action drops / duplicates; "sleep"
                # on send_delay stalls the sender inline
                if fail_point("transport::drop_send") is not None:
                    continue
                fail_point("transport::send_delay")
                self._inbox.append(m)
                if fail_point("transport::dup_send") is not None:
                    self._inbox.append(m)
            node.advance(rd)

    def _apply(self, nid: int, entry) -> None:
        from .messages import ConfChange, EntryType
        if entry.entry_type is EntryType.CONF_CHANGE:
            if entry.data:
                self.nodes[nid].apply_conf_change(
                    ConfChange.from_bytes(entry.data))
        elif entry.data:
            self.applied[nid].append((entry.index, entry.data))

    def deliver_all(self) -> int:
        """Route queued messages until quiescent; returns deliveries."""
        n = 0
        for nid in self.nodes:
            self._drain_node(nid)
        while self._inbox:
            if len(self._inbox) > 1 and \
                    fail_point("transport::reorder") is not None:
                self._chaos_rng.shuffle(self._inbox)
            m = self._inbox.pop(0)
            if fail_point("transport::drop_recv") is not None:
                continue
            if m.to in self.nodes:
                self.nodes[m.to].step(m)
                self._drain_node(m.to)
                n += 1
        return n

    def tick_all(self, times: int = 1) -> None:
        for _ in range(times):
            for node in self.nodes.values():
                node.tick()
            self.deliver_all()

    # -- conveniences --

    def elect(self, nid: int) -> None:
        """Force ``nid`` to campaign and win (assuming connectivity)."""
        from .messages import MsgType
        self.nodes[nid].step(Message(MsgType.HUP))
        self.deliver_all()
        assert self.leader() == nid, \
            f"expected {nid} to win, leader={self.leader()}"

    def leader(self) -> Optional[int]:
        leaders = [nid for nid, n in self.nodes.items()
                   if n.state == "leader"]
        if not leaders:
            return None
        # the one with the highest term wins (stale leaders may linger
        # until they hear the new term)
        return max(leaders, key=lambda nid: self.nodes[nid].term)

    def propose(self, data: bytes) -> int:
        lead = self.leader()
        assert lead is not None, "no leader"
        idx = self.nodes[lead].propose(data)
        self.deliver_all()
        return idx

    def committed_data(self, nid: int) -> list:
        return [d for _, d in self.applied[nid]]
