"""The Raft state machine (RawNode + Ready interface).

A copy of the JAX package's ``raft/raw_node.py``.

Reference capability: raft-rs (RawNode::tick/step/propose/ready/advance),
which the reference's raftstore drives from its poll loop
(components/raftstore/src/store/fsm/peer.rs).  Implements the raft paper
with the extensions TiKV relies on: pre-vote (§9.6 extension), leader
transfer via TIMEOUT_NOW, rejection hints for fast log backtracking,
snapshot-based catch-up, and single-step membership change with the
one-in-flight rule.

Deviations tracked for later rounds: joint consensus (the reference
supports it via raft-rs; tests/integrations test_joint_consensus.rs),
check-quorum/lease-read safety is provided one layer up (raftstore lease).

Determinism: no wall clock, no global RNG — ``tick()`` advances logical
time and election timeouts are drawn from a node-seeded PRNG, so cluster
tests replay identically.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

from .messages import (
    ConfChange,
    ConfChangeType,
    Entry,
    EntryType,
    HardState,
    Message,
    MsgType,
    Snapshot,
)
from .storage import MemoryRaftStorage

FOLLOWER = "follower"
PRE_CANDIDATE = "pre_candidate"
CANDIDATE = "candidate"
LEADER = "leader"

# Progress replication states (raft-rs progress.rs)
PROBE = "probe"
REPLICATE = "replicate"
SNAPSHOT = "snapshot"

_MAX_APPEND_ENTRIES = 256


@dataclass
class Progress:
    """Leader's view of one follower (raft-rs Progress)."""

    match: int = 0
    next: int = 1
    state: str = PROBE
    pending_snapshot: int = 0
    paused: bool = False


@dataclass
class Ready:
    """Work handed to the application per turn (raft-rs Ready)."""

    messages: list = field(default_factory=list)
    entries: list = field(default_factory=list)          # persist these
    committed_entries: list = field(default_factory=list)  # apply these
    hard_state: Optional[HardState] = None               # persist if set
    snapshot: Optional[Snapshot] = None                  # install if set
    soft_state: Optional[tuple] = None                   # (leader_id, role)


class RawNode:
    def __init__(self, node_id: int, storage: MemoryRaftStorage,
                 election_tick: int = 10, heartbeat_tick: int = 2,
                 pre_vote: bool = True, seed: int = 0,
                 tick_interval: Optional[float] = None):
        self.id = node_id
        self.storage = storage
        self._election_tick = election_tick
        self._heartbeat_tick = heartbeat_tick
        self._pre_vote = pre_vote
        # wall-clock seconds per tick, when the driver ticks on real time
        # (server/node.py).  None = manually-driven ticks (in-process
        # tests); the lease then rests on tick counts alone.
        self._tick_interval = tick_interval
        self._rng = random.Random((seed << 16) ^ node_id)

        hs, voters, learners = storage.initial_state()
        self.term = hs.term
        self.vote = hs.vote
        self.commit = hs.commit
        self.voters: set[int] = set(voters)
        # unsafe recovery: voter ids certified dead — excluded from all
        # quorums while non-empty (in-memory only; PD re-issues the
        # recovery plan after a restart, store/unsafe_recovery.rs)
        self.force_failed: set[int] = set()
        self.learners: set[int] = set(learners)
        # joint consensus (raft §6): non-empty while in C_old,new —
        # commits and elections then need majorities of BOTH sets
        init_out = getattr(storage, "initial_outgoing", None)
        self.voters_outgoing: set[int] = \
            set(init_out()) if callable(init_out) else set()

        self.state = FOLLOWER
        self.leader_id = 0
        self.progress: dict[int, Progress] = {}
        self._votes: dict[int, bool] = {}
        self._msgs: list[Message] = []
        self._elapsed = 0
        self._timeout = 0
        self._reset_timeout()

        self.applied = storage.snapshot.metadata.index
        self._stable_index = storage.last_index()
        self._last_applied_snapshot = storage.snapshot.metadata.index
        self._pending_snapshot: Optional[Snapshot] = None
        self._pending_conf_index = storage.last_index() \
            if self._has_pending_conf_entry() else 0
        self._lead_transferee = 0
        self._prev_hs = HardState(self.term, self.vote, self.commit)
        self._prev_soft = (self.leader_id, self.state)
        # leader lease (store/worker/read.rs ReadDelegate semantics, in
        # tick units): heartbeats carry the send tick; acks prove a
        # quorum heard from us within the lease window.  The reference
        # measures the lease in monotonic time (ReadDelegate
        # maybe_renew_lease); tick counts alone break when the tick loop
        # stalls (fsync pause, GC) while followers keep wall-clock time —
        # so each heartbeat's send is also stamped with time.monotonic()
        # and in_lease() cross-checks wall-clock age when tick_interval
        # is known.
        self._tick_count = 0
        self._lease_ack: dict[int, int] = {}
        self._hb_send_mono: dict[int, float] = {}   # send tick -> mono
        self._lease_ack_mono: dict[int, float] = {}  # nid -> mono of ack'd hb
        # ReadIndex answers: (commit index, ctx) pairs the peer drains
        self.read_states: list[tuple[int, int]] = []

    # ------------------------------------------------------------- helpers

    def _pending_conf_entry_index(self) -> int:
        last = 0
        for e in self.storage.entries:
            if e.entry_type is EntryType.CONF_CHANGE and \
                    e.index > self.applied:
                last = max(last, e.index)
        return last

    def _has_pending_conf_entry(self) -> bool:
        return self._pending_conf_entry_index() > 0

    def _reset_timeout(self) -> None:
        self._elapsed = 0
        self._timeout = self._rng.randint(self._election_tick,
                                          2 * self._election_tick - 1)

    def last_index(self) -> int:
        return self.storage.last_index()

    def last_term(self) -> int:
        t = self.storage.term(self.last_index())
        return t if t is not None else 0

    def _quorum(self) -> int:
        return len(self.voters) // 2 + 1

    def in_joint(self) -> bool:
        return bool(self.voters_outgoing)

    def all_voters(self) -> set:
        return self.voters | self.voters_outgoing

    def _majority_of(self, ids: set, granted) -> bool:
        """``granted(nid) -> bool`` holds for a majority of ``ids``.

        Unsafe recovery (store/unsafe_recovery.rs ForceLeader): voters
        declared failed are excluded from every quorum computation, so
        the surviving minority can elect and commit the membership
        change that removes the dead peers.
        """
        if self.force_failed:
            ids = ids - self.force_failed
        if not ids:
            return True
        return sum(1 for nid in ids if granted(nid)) >= \
            len(ids) // 2 + 1

    def _joint_won(self, granted) -> bool:
        """Joint decision rule: majority of the incoming set AND (while
        joint) of the outgoing set (raft §6 C_old,new)."""
        return self._majority_of(self.voters, granted) and \
            self._majority_of(self.voters_outgoing, granted)

    def _send(self, m: Message) -> None:
        m.frm = self.id
        if m.term == 0 and m.msg_type not in (MsgType.PRE_VOTE,):
            m.term = self.term
        self._msgs.append(m)

    # ------------------------------------------------------------- roles

    def _become_follower(self, term: int, leader_id: int) -> None:
        if term > self.term:
            self.term = term
            self.vote = 0
        self.state = FOLLOWER
        self.leader_id = leader_id
        self._lead_transferee = 0
        self._reset_timeout()

    def _become_pre_candidate(self) -> None:
        self.state = PRE_CANDIDATE
        self.leader_id = 0
        self._votes = {self.id: True}
        self._reset_timeout()

    def _become_candidate(self) -> None:
        self.state = CANDIDATE
        self.term += 1
        self.vote = self.id
        self.leader_id = 0
        self._votes = {self.id: True}
        self._reset_timeout()

    def _become_leader(self) -> None:
        self.state = LEADER
        self.leader_id = self.id
        # recompute the one-in-flight gate from the log: a new leader
        # inheriting a committed-but-unapplied conf entry must not
        # accept another conf change before applying it (raft-rs does
        # the same when campaigning)
        self._pending_conf_index = max(self._pending_conf_index,
                                       self._pending_conf_entry_index())
        self._lead_transferee = 0
        self._lease_ack = {}
        self._hb_send_mono = {}
        self._lease_ack_mono = {}
        last = self.last_index()
        self.progress = {
            nid: Progress(match=0, next=last + 1)
            for nid in self.voters | self.voters_outgoing | self.learners
            if nid != self.id
        }
        self.progress[self.id] = Progress(match=last, next=last + 1,
                                          state=REPLICATE)
        # noop entry to commit entries from previous terms (§5.4.2)
        self._append_entries([Entry(self.term, last + 1)])
        self._broadcast_append()
        self._maybe_commit()

    # ------------------------------------------------------------- ticking

    def tick(self) -> None:
        self._tick_count += 1
        self._elapsed += 1
        if self.state == LEADER:
            if self._elapsed >= self._heartbeat_tick:
                self._elapsed = 0
                self._broadcast_heartbeat()
        else:
            if self._elapsed >= self._timeout and \
                    self.id in self.voters:
                self._reset_timeout()
                self.campaign()

    def in_lease(self) -> bool:
        """Leader lease check for local (no-consensus) reads.

        Safe iff (a) pre-vote is on — a follower with live leader contact
        rejects pre-votes until its election timer (≥ election_tick
        ticks) expires, so no rival can be elected while a quorum acked
        our heartbeats within the last election_tick-2 ticks (measured
        from heartbeat SEND tick; 2 ticks of margin absorb cross-node
        tick skew the way the reference subtracts clock drift from
        max_lease); and (b) no leader transfer is in flight (the target
        campaigns immediately via TIMEOUT_NOW).
        """
        if self.state != LEADER or not self._pre_vote or \
                self._lead_transferee or self.force_failed:
            return False
        window = self._election_tick - 2
        if window <= 0:
            return False
        floor = self._tick_count - window
        # Only voters with a recorded ack count: a freshly-(re)started
        # leader has floor <= 0 and must not treat silent voters as live
        # (ADVICE r2: TIMEOUT_NOW transferee could serve lease reads with
        # zero acks).
        now = time.monotonic() if self._tick_interval is not None else None
        max_age = None if now is None else window * self._tick_interval

        def ack_live(nid: int) -> bool:
            if nid not in self._lease_ack or self._lease_ack[nid] < floor:
                return False
            if max_age is None:
                return True
            # wall-clock cross-check: if the tick loop stalled, tick
            # counts freeze while followers' election timers keep running
            # in real time — the ack must also be recent in mono time
            mono = self._lease_ack_mono.get(nid)
            return mono is not None and (now - mono) <= max_age

        def live(nid):
            return nid == self.id or ack_live(nid)
        return self._joint_won(live)

    def enter_force_leader(self, failed: set) -> None:
        """Unsafe recovery: certify ``failed`` voter ids as dead and
        campaign with the surviving minority as the full quorum.

        Refused when the survivors alone still form a majority — a
        normal election must be used then (the reference's PD-driven
        plan applies the same gate), and when this node is itself in the
        failed set.
        """
        failed = set(failed) & self.all_voters()
        if self.id in failed:
            raise ValueError("cannot force-lead from a failed voter")

        def alive_majority(ids: set) -> bool:
            if not ids:
                return True
            return sum(1 for n in ids if n not in failed) >= \
                len(ids) // 2 + 1
        # refuse only when a NORMAL election could still win — in a
        # joint config that needs a live majority of BOTH sets
        if alive_majority(self.voters) and \
                alive_majority(self.voters_outgoing):
            raise ValueError(
                "survivors form a quorum; use a normal election")
        self.force_failed = failed
        self.campaign(force=True)

    def exit_force_leader(self) -> None:
        self.force_failed = set()

    def campaign(self, force: bool = False) -> None:
        if self._pre_vote and not force:
            self._become_pre_candidate()
            if self._tally_won():                   # single node
                self._campaign_real()
                return
            for nid in self.all_voters():
                if nid == self.id:
                    continue
                self._msgs.append(Message(
                    MsgType.PRE_VOTE, to=nid, frm=self.id,
                    term=self.term + 1, log_term=self.last_term(),
                    index=self.last_index()))
        else:
            self._campaign_real()

    def _campaign_real(self) -> None:
        self._become_candidate()
        if self._tally_won():                       # single node wins now
            self._become_leader()
            return
        for nid in self.all_voters():
            if nid == self.id:
                continue
            self._send(Message(
                MsgType.REQUEST_VOTE, to=nid, term=self.term,
                log_term=self.last_term(), index=self.last_index()))

    def _tally_won(self) -> bool:
        return self._joint_won(
            lambda nid: self._votes.get(nid, False))

    def _tally_lost(self) -> bool:
        """A majority of either set rejected: the election cannot win."""
        def rejected(nid):
            return nid in self._votes and not self._votes[nid]
        return (self._majority_of(self.voters, rejected) and
                bool(self.voters)) or \
            (bool(self.voters_outgoing) and
             self._majority_of(self.voters_outgoing, rejected))

    # ------------------------------------------------------------- propose

    def propose(self, data: bytes) -> int:
        """Append a proposal; returns its index.  Raises if not leader."""
        if self.state != LEADER:
            raise NotLeader(self.leader_id)
        if self.force_failed:
            # force-leader mode exists ONLY to drive the membership
            # change that evicts dead voters (unsafe_recovery.rs: normal
            # proposals are rejected until recovery completes)
            raise ProposalDropped("force leader: recovery in progress")
        if self._lead_transferee:
            raise ProposalDropped("leader transfer in progress")
        index = self.last_index() + 1
        self._append_entries([Entry(self.term, index, data)])
        self._broadcast_append()
        self._maybe_commit()
        return index

    def propose_conf_change(self, cc: ConfChange) -> int:
        if self.state != LEADER:
            raise NotLeader(self.leader_id)
        if self._pending_conf_index > self.applied:
            raise ProposalDropped("conf change already in flight")
        index = self.last_index() + 1
        self._append_entries([Entry(self.term, index, cc.to_bytes(),
                                    EntryType.CONF_CHANGE)])
        self._pending_conf_index = index
        self._broadcast_append()
        self._maybe_commit()
        return index

    def apply_conf_change(self, cc: ConfChange) -> None:
        """Called by the application after applying a conf-change entry."""
        if cc.change_type is ConfChangeType.ADD_NODE:
            self.learners.discard(cc.node_id)
            self.voters.add(cc.node_id)
            if self.state == LEADER and cc.node_id not in self.progress:
                self.progress[cc.node_id] = Progress(
                    match=0, next=self.last_index() + 1)
        elif cc.change_type is ConfChangeType.ADD_LEARNER:
            self.voters.discard(cc.node_id)
            self.learners.add(cc.node_id)
            if self.state == LEADER and cc.node_id not in self.progress:
                self.progress[cc.node_id] = Progress(
                    match=0, next=self.last_index() + 1)
        else:
            self.voters.discard(cc.node_id)
            self.learners.discard(cc.node_id)
            self.progress.pop(cc.node_id, None)
        self.storage.set_conf(sorted(self.voters), sorted(self.learners),
                              sorted(self.voters_outgoing))
        if self.state == LEADER:
            self._maybe_commit()    # quorum may have shrunk

    def propose_conf_change_v2(self, cc2, force: bool = False) -> int:
        """Propose a joint membership change (raft §6; raft-rs
        ConfChangeV2).  Same one-in-flight rule as V1; ``force`` is the
        auto-leave path — the LEAVE is proposed from the ENTER's apply,
        where the enter is by definition the pending change it
        supersedes (raft-rs auto transition does the same)."""
        if self.state != LEADER:
            raise NotLeader(self.leader_id)
        if not force and self._pending_conf_index > self.applied:
            raise ProposalDropped("conf change already in flight")
        if not cc2.leave_joint and self.in_joint():
            raise ProposalDropped("already in a joint config")
        index = self.last_index() + 1
        self._append_entries([Entry(self.term, index, cc2.to_bytes(),
                                    EntryType.CONF_CHANGE)])
        self._pending_conf_index = index
        self._broadcast_append()
        self._maybe_commit()
        return index

    def apply_conf_change_v2(self, cc2) -> None:
        """Apply an enter-joint or leave-joint entry.

        Enter: outgoing = current voters; the change list produces the
        incoming set; decisions need BOTH majorities until leave.
        Leave: outgoing clears; nodes in neither set drop out.
        """
        if cc2.leave_joint:
            gone = self.voters_outgoing - self.voters - self.learners
            self.voters_outgoing = set()
            for nid in gone:
                self.progress.pop(nid, None)
        else:
            if self.in_joint():
                # raft-rs rejects entering a joint config while one is
                # active — overwriting outgoing would drop the real
                # C_old and break the both-majority invariant
                return False
            self.voters_outgoing = set(self.voters)
            for ctype, nid in cc2.changes:
                if ctype is ConfChangeType.ADD_NODE:
                    self.learners.discard(nid)
                    self.voters.add(nid)
                elif ctype is ConfChangeType.ADD_LEARNER:
                    self.voters.discard(nid)
                    self.learners.add(nid)
                else:       # REMOVE_NODE
                    self.voters.discard(nid)
                    self.learners.discard(nid)
            if self.state == LEADER:
                for nid in (self.voters | self.learners) -                         set(self.progress) - {self.id}:
                    self.progress[nid] = Progress(
                        match=0, next=self.last_index() + 1)
        self.storage.set_conf(sorted(self.voters), sorted(self.learners),
                              sorted(self.voters_outgoing))
        if self.state == LEADER:
            self._maybe_commit()
        return True

    def transfer_leader(self, target: int) -> None:
        self.step(Message(MsgType.TRANSFER_LEADER, to=self.id,
                          frm=target, term=self.term))

    # ------------------------------------------------------------- log ops

    def _append_entries(self, entries: Sequence[Entry]) -> None:
        self.storage.append(list(entries))
        if self.state == LEADER:
            pr = self.progress[self.id]
            pr.match = self.last_index()
            pr.next = pr.match + 1

    def _broadcast_append(self) -> None:
        for nid in list(self.progress):
            if nid != self.id:
                self._send_append(nid)

    def _send_append(self, to: int) -> None:
        pr = self.progress[to]
        if pr.state == SNAPSHOT or pr.paused:
            return
        prev_index = pr.next - 1
        prev_term = self.storage.term(prev_index)
        if prev_term is None:   # compacted: ship a snapshot
            self._send_snapshot(to)
            return
        hi = min(self.last_index() + 1, pr.next + _MAX_APPEND_ENTRIES)
        entries = tuple(self.storage.slice(pr.next, hi))
        if pr.state == PROBE and entries:
            pr.paused = True    # one probe in flight until acked
        self._send(Message(
            MsgType.APPEND, to=to, term=self.term, log_term=prev_term,
            index=prev_index, entries=entries, commit=self.commit))

    def _send_snapshot(self, to: int) -> None:
        snap = self.storage.snapshot_for_send()
        if snap.metadata.index == 0:
            return
        pr = self.progress[to]
        pr.state = SNAPSHOT
        pr.pending_snapshot = snap.metadata.index
        self._send(Message(MsgType.SNAPSHOT, to=to, term=self.term,
                           snapshot=snap))

    def _broadcast_heartbeat(self) -> None:
        if self._tick_interval is not None:
            self._hb_send_mono[self._tick_count] = time.monotonic()
            if len(self._hb_send_mono) > 4 * self._election_tick:
                horizon = self._tick_count - 2 * self._election_tick
                for t in [t for t in self._hb_send_mono if t < horizon]:
                    del self._hb_send_mono[t]
        for nid, pr in self.progress.items():
            if nid == self.id:
                continue
            self._send(Message(MsgType.HEARTBEAT, to=nid, term=self.term,
                               commit=min(pr.match, self.commit),
                               ctx=self._tick_count))

    def _commit_index_of(self, ids: set) -> int:
        if self.force_failed:
            ids = ids - self.force_failed
            if not ids:
                # every voter of this set is certified dead: the set
                # imposes NO constraint (mirrors _majority_of's vacuous
                # truth) — 0 would freeze commits during recovery
                return 1 << 62
        matches = sorted((self.progress[nid].match for nid in ids
                          if nid in self.progress), reverse=True)
        if len(matches) < len(ids) // 2 + 1:
            return 0
        return matches[len(ids) // 2]

    def _maybe_commit(self) -> bool:
        if not self.progress:
            return False
        n = self._commit_index_of(self.voters)
        if self.in_joint():
            # joint rule: an index commits only when BOTH configs'
            # majorities replicated it (raft §6)
            n = min(n, self._commit_index_of(self.voters_outgoing))
        if n > self.commit and self.storage.term(n) == self.term:
            self.commit = n
            return True
        return False

    # ------------------------------------------------------------- step

    def step(self, m: Message) -> None:
        if m.msg_type is MsgType.HUP:
            self.campaign()
            return
        if m.msg_type is MsgType.TRANSFER_LEADER:
            self._handle_transfer(m)
            return

        # term bookkeeping (raft-rs raft.rs Step)
        if m.term > self.term:
            if m.msg_type in (MsgType.PRE_VOTE,):
                pass    # pre-vote never bumps terms
            elif m.msg_type is MsgType.PRE_VOTE_RESPONSE and not m.reject:
                pass    # counted below; term bump happens on real campaign
            else:
                lead = m.frm if m.msg_type in (
                    MsgType.APPEND, MsgType.HEARTBEAT, MsgType.SNAPSHOT) \
                    else 0
                self._become_follower(m.term, lead)
        elif m.term < self.term:
            if m.msg_type in (MsgType.APPEND, MsgType.HEARTBEAT,
                              MsgType.SNAPSHOT):
                # stale leader: tell it the new term
                self._send(Message(MsgType.APPEND_RESPONSE, to=m.frm,
                                   term=self.term, reject=True,
                                   reject_hint=self.last_index()))
            elif m.msg_type is MsgType.PRE_VOTE:
                self._send(Message(MsgType.PRE_VOTE_RESPONSE, to=m.frm,
                                   term=self.term, reject=True))
            return

        handler = {
            MsgType.PRE_VOTE: self._handle_pre_vote,
            MsgType.PRE_VOTE_RESPONSE: self._handle_pre_vote_response,
            MsgType.REQUEST_VOTE: self._handle_vote,
            MsgType.REQUEST_VOTE_RESPONSE: self._handle_vote_response,
            MsgType.APPEND: self._handle_append,
            MsgType.APPEND_RESPONSE: self._handle_append_response,
            MsgType.HEARTBEAT: self._handle_heartbeat,
            MsgType.HEARTBEAT_RESPONSE: self._handle_heartbeat_response,
            MsgType.SNAPSHOT: self._handle_snapshot,
            MsgType.TIMEOUT_NOW: self._handle_timeout_now,
            MsgType.READ_INDEX: self._handle_read_index,
            MsgType.READ_INDEX_RESP: self._handle_read_index_resp,
        }.get(m.msg_type)
        if handler is not None:
            handler(m)

    # -- follower reads (raft §6.4 ReadIndex) --

    def request_read_index(self, ctx: int, read_ts: int = 0) -> bool:
        """Follower/replica read: ask the leader for its commit index;
        the answer lands in ``read_states``.  ``read_ts`` piggybacks so
        the leader can bump its concurrency manager's max_ts and veto
        reads that would race an async-commit prewrite.  Returns False
        when no leader is known (the peer's tick retries)."""
        if self.state == LEADER:
            self._handle_read_index(Message(MsgType.READ_INDEX,
                                            to=self.id, frm=self.id,
                                            term=self.term, ctx=ctx,
                                            index=read_ts))
            return True
        if not self.leader_id:
            return False
        self._send(Message(MsgType.READ_INDEX, to=self.leader_id,
                           term=self.term, ctx=ctx, index=read_ts))
        return True

    def _handle_read_index(self, m: Message) -> None:
        if self.state != LEADER:
            return      # stale routing; requester retries
        # the leader may only answer once it has committed in ITS term
        # (an old-term commit index could run behind a newer leader)
        if self.storage.term(self.commit) != self.term:
            return      # pending noop: requester retries
        # leadership confirmation (raft §6.4): a deposed leader behind a
        # partition must NOT answer with its stale commit index — the
        # quorum-acked lease is the evidence a heartbeat round would
        # give (the same basis LocalReader uses)
        if not self.in_lease():
            return      # requester retries; a live leader re-earns it
        # async-commit integration hook: the storage layer bumps max_ts
        # for the piggybacked read_ts and vetoes when an in-flight
        # prewrite's memory lock covers it (concurrency_manager)
        hook = getattr(self, "read_index_hook", None)
        if hook is not None and m.index and not hook(m.index):
            return      # blocked by a memory lock: requester retries
        if m.frm == self.id:
            self.read_states.append((self.commit, m.ctx))
        else:
            self._send(Message(MsgType.READ_INDEX_RESP, to=m.frm,
                               term=self.term, index=self.commit,
                               ctx=m.ctx))

    def _handle_read_index_resp(self, m: Message) -> None:
        self.read_states.append((m.index, m.ctx))

    # -- elections --

    def _log_up_to_date(self, m: Message) -> bool:
        lt, li = self.last_term(), self.last_index()
        return m.log_term > lt or (m.log_term == lt and m.index >= li)

    def _handle_pre_vote(self, m: Message) -> None:
        # grant if we'd grant a real vote at that term and have no live
        # leader contact (approximated by elapsed timeout share)
        grant = m.term > self.term and self._log_up_to_date(m) and \
            (self.leader_id == 0 or self._elapsed >= self._timeout)
        self._send(Message(MsgType.PRE_VOTE_RESPONSE, to=m.frm,
                           term=m.term, reject=not grant))

    def _handle_pre_vote_response(self, m: Message) -> None:
        if self.state != PRE_CANDIDATE:
            return
        self._votes[m.frm] = not m.reject
        if self._tally_won():
            self._campaign_real()
        elif self._tally_lost():
            self._become_follower(self.term, 0)

    def _handle_vote(self, m: Message) -> None:
        can_vote = (self.vote == 0 and self.leader_id == 0) or \
            self.vote == m.frm
        grant = can_vote and self._log_up_to_date(m)
        if grant:
            self.vote = m.frm
            self._reset_timeout()
        self._send(Message(MsgType.REQUEST_VOTE_RESPONSE, to=m.frm,
                           term=self.term, reject=not grant))

    def _handle_vote_response(self, m: Message) -> None:
        if self.state != CANDIDATE:
            return
        self._votes[m.frm] = not m.reject
        if self._tally_won():
            self._become_leader()
        elif self._tally_lost():
            self._become_follower(self.term, 0)

    # -- replication (follower side) --

    def _handle_append(self, m: Message) -> None:
        self.leader_id = m.frm
        self._reset_timeout()
        if m.index < self.commit:
            # stale prefix; never truncate below commit
            self._send(Message(MsgType.APPEND_RESPONSE, to=m.frm,
                               term=self.term, index=self.commit))
            return
        local_term = self.storage.term(m.index)
        if local_term is None or local_term != m.log_term:
            self._send(Message(
                MsgType.APPEND_RESPONSE, to=m.frm, term=self.term,
                reject=True, index=m.index,
                reject_hint=min(self.last_index(), m.index)))
            return
        # find first conflicting entry; truncate from there
        to_append: list[Entry] = []
        for e in m.entries:
            t = self.storage.term(e.index)
            if t is None or t != e.term:
                to_append = [x for x in m.entries if x.index >= e.index]
                break
        if to_append:
            self.storage.append(to_append)
            if to_append[0].index <= self._stable_index:
                self._stable_index = to_append[0].index - 1
        last_new = m.index + len(m.entries)
        if m.commit > self.commit:
            self.commit = min(m.commit, last_new)
        self._send(Message(MsgType.APPEND_RESPONSE, to=m.frm,
                           term=self.term, index=last_new))

    def _handle_heartbeat(self, m: Message) -> None:
        self.leader_id = m.frm
        self._reset_timeout()
        if m.commit > self.commit:
            self.commit = min(m.commit, self.last_index())
        self._send(Message(MsgType.HEARTBEAT_RESPONSE, to=m.frm,
                           term=self.term, index=self.last_index(),
                           ctx=m.ctx))

    def _handle_snapshot(self, m: Message) -> None:
        self.leader_id = m.frm
        self._reset_timeout()
        meta = m.snapshot.metadata
        if meta.index <= self.commit:
            self._send(Message(MsgType.APPEND_RESPONSE, to=m.frm,
                               term=self.term, index=self.commit))
            return
        # fast-forward: restore config + log position from the snapshot
        self._pending_snapshot = m.snapshot
        self.storage.apply_snapshot(m.snapshot)
        self.voters = set(meta.voters)
        self.learners = set(meta.learners)
        # a snapshot generated mid-joint carries C_old: the receiver
        # must enforce both majorities too, or it could elect itself on
        # an incoming-only majority (split brain in the joint window)
        self.voters_outgoing = set(
            getattr(meta, "voters_outgoing", ()))
        self.commit = meta.index
        self.applied = meta.index
        self._stable_index = meta.index
        self._send(Message(MsgType.APPEND_RESPONSE, to=m.frm,
                           term=self.term, index=meta.index))

    def _handle_timeout_now(self, m: Message) -> None:
        if self.id in self.voters:
            self.campaign(force=True)

    # -- replication (leader side) --

    def _handle_append_response(self, m: Message) -> None:
        if self.state != LEADER:
            return
        pr = self.progress.get(m.frm)
        if pr is None:
            return
        pr.paused = False
        if m.reject:
            if m.term > self.term:
                return      # already stepped down in step()
            pr.next = max(min(m.reject_hint, pr.next - 1), pr.match + 1)
            pr.state = PROBE
            self._send_append(m.frm)
            return
        if pr.state == SNAPSHOT and m.index >= pr.pending_snapshot:
            pr.state = PROBE
            pr.pending_snapshot = 0
        if m.index > pr.match:
            pr.match = m.index
            pr.next = max(pr.next, m.index + 1)
            pr.state = REPLICATE
            if self._maybe_commit():
                self._broadcast_append()
            elif pr.next <= self.last_index():
                self._send_append(m.frm)
            if m.frm == self._lead_transferee and \
                    pr.match == self.last_index():
                self._send(Message(MsgType.TIMEOUT_NOW, to=m.frm,
                                   term=self.term))

    def _handle_heartbeat_response(self, m: Message) -> None:
        if self.state != LEADER:
            return
        pr = self.progress.get(m.frm)
        if pr is None:
            return
        # explicit None check: a heartbeat broadcast at tick 0 carries
        # ctx == 0, which must still count as a lease ack
        if m.ctx is not None:
            prev = self._lease_ack.get(m.frm)
            if prev is None or m.ctx > prev:
                self._lease_ack[m.frm] = m.ctx
                mono = self._hb_send_mono.get(m.ctx)
                if mono is not None:
                    self._lease_ack_mono[m.frm] = mono
        pr.paused = False
        if pr.match < self.last_index():
            self._send_append(m.frm)

    def _handle_transfer(self, m: Message) -> None:
        target = m.frm
        if self.state != LEADER or target == self.id or \
                target not in self.voters:
            return
        self._lead_transferee = target
        pr = self.progress[target]
        if pr.match == self.last_index():
            self._send(Message(MsgType.TIMEOUT_NOW, to=target,
                               term=self.term))
        else:
            self._send_append(target)

    # ------------------------------------------------------------- ready

    def has_ready(self) -> bool:
        hs = HardState(self.term, self.vote, self.commit)
        return bool(self._msgs) or \
            self.last_index() > self._stable_index or \
            self.commit > self.applied or \
            self._pending_snapshot is not None or \
            (hs.term, hs.vote, hs.commit) != \
            (self._prev_hs.term, self._prev_hs.vote, self._prev_hs.commit) \
            or (self.leader_id, self.state) != self._prev_soft

    def ready(self) -> Ready:
        rd = Ready()
        rd.messages, self._msgs = self._msgs, []
        if self.last_index() > self._stable_index:
            lo = max(self._stable_index + 1, self.storage.first_index())
            rd.entries = self.storage.slice(lo, self.last_index() + 1)
        if self.commit > self.applied:
            lo = max(self.applied + 1, self.storage.first_index())
            rd.committed_entries = self.storage.slice(lo, self.commit + 1)
        hs = HardState(self.term, self.vote, self.commit)
        if (hs.term, hs.vote, hs.commit) != \
                (self._prev_hs.term, self._prev_hs.vote, self._prev_hs.commit):
            rd.hard_state = hs
        soft = (self.leader_id, self.state)
        if soft != self._prev_soft:
            rd.soft_state = soft
        rd.snapshot = self._pending_snapshot
        return rd

    def advance(self, rd: Ready) -> None:
        if rd.entries:
            # raft-rs stable_to: only raise the stable mark if the log
            # still holds the SAME entry — a truncation during an
            # async-IO persist window invalidated this batch, and
            # blindly advancing would let unpersisted replacement
            # entries skip their WAL write
            last = rd.entries[-1]
            if self.storage.term(last.index) == last.term:
                self._stable_index = max(self._stable_index, last.index)
        if rd.committed_entries:
            self.applied = rd.committed_entries[-1].index
        if rd.hard_state is not None:
            self.storage.set_hard_state(rd.hard_state)
            self._prev_hs = rd.hard_state
        if rd.soft_state is not None:
            self._prev_soft = rd.soft_state
        self._pending_snapshot = None


class NotLeader(Exception):
    def __init__(self, leader_id: int):
        super().__init__(f"not leader (hint: {leader_id})")
        self.leader_id = leader_id


class ProposalDropped(Exception):
    pass
