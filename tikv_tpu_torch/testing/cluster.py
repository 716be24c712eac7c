"""In-process multi-store cluster fixture.

A copy of the JAX package's ``testing/cluster.py`` without unsafe
recovery after a majority loss and the execution of PD's scheduling
operators (the port's PD has no scheduler): ``SimTransport`` routes raft
messages between the stores with message-level fault injection, and
``Cluster`` bootstraps, pumps, splits, merges, changes peers (plain and
joint), transfers leaders, checks consistency, partitions, stops and
restarts its stores.  A store's engine is the port's ``MemoryEngine``
unless an ``engine_factory`` is given.

Reference: components/test_raftstore/src/cluster.rs (``Cluster`` with the
node simulator — routers wired directly, no RPC) plus
transport_simulate.rs message filters and the in-memory PD
(test_raftstore/src/pd.rs).  SURVEY.md §4 names this fixture as the
foundation of the reference's integration pyramid.
"""

from __future__ import annotations

import struct
from typing import Callable, Optional

from ..codec.keys import data_key
from ..engine.memory import MemoryEngine
from ..engine.traits import CF_DEFAULT
from ..pd.client import MockPd
from ..raftstore import (
    AdminCmd,
    NotLeaderError,
    Peer,
    RaftCmd,
    RaftKv,
    RaftStore,
    Region,
    RegionEpoch,
    Store,
)


class SimTransport:
    """Shared in-process transport with message-level fault injection.

    Besides boolean filters (drop/partition), a seeded ``chaos`` mode
    enables deterministic message-level turbulence the way
    transport_simulate.rs's Delay/OutOfOrder filters do:

        transport.set_chaos(rng, delay_p=0.2, dup_p=0.1, reorder=True)

    - ``reorder``: each routing round shuffles the pending queue;
    - ``delay_p``: a message is held back one routing round;
    - ``dup_p``: a message is delivered twice.

    All randomness comes from the injected ``rng``, so a fault schedule
    is reproducible from its seed.
    """

    def __init__(self):
        self.stores: dict[int, RaftStore] = {}
        self.queue: list[tuple] = []
        # filters: fn(from_store, to_store, region_id, msg) -> deliver?
        self.filters: list[Callable] = []
        self._chaos = None      # (rng, delay_p, dup_p, reorder)

    def set_chaos(self, rng, delay_p: float = 0.0, dup_p: float = 0.0,
                  reorder: bool = False) -> None:
        self._chaos = (rng, delay_p, dup_p, reorder)

    def clear_chaos(self) -> None:
        self._chaos = None

    def send(self, to_store, region_id, to_peer, from_peer, msg) -> None:
        from ..utils.failpoint import fail_point
        if fail_point("sim_transport::drop_send") is not None:
            return
        self.queue.append((to_store, region_id, to_peer, from_peer, msg))

    def _deliver(self, ent) -> int:
        from ..utils.failpoint import fail_point
        to_store, region_id, to_peer, from_peer, msg = ent
        if not all(f(from_peer.store_id, to_store, region_id, msg)
                   for f in self.filters):
            return 0
        if fail_point("sim_transport::drop_recv") is not None:
            return 0
        store = self.stores.get(to_store)
        if store is None:
            return 0
        store.on_raft_message(region_id, to_peer, from_peer, msg)
        return 1

    def route_all(self) -> int:
        n = 0
        if self._chaos is None:
            while self.queue:
                n += self._deliver(self.queue.pop(0))
            return n
        # chaos mode: one ROUND per call — delayed messages stay queued
        # for the next round so the pump loop re-drives them (an
        # unbounded in-round requeue would never terminate)
        rng, delay_p, dup_p, reorder = self._chaos
        pending, self.queue = self.queue, []
        if reorder and len(pending) > 1:
            rng.shuffle(pending)
        for ent in pending:
            if delay_p and rng.random() < delay_p:
                self.queue.append(ent)
                continue
            n += self._deliver(ent)
            if dup_p and rng.random() < dup_p:
                n += self._deliver(ent)
        return n


class Cluster:
    """N stores, one shared transport, one mock PD."""

    def __init__(self, n_stores: int = 3, pd: Optional[MockPd] = None,
                 seed: int = 0, engine_factory: Optional[Callable] = None):
        """``engine_factory(store_id) -> KvEngine`` swaps the per-store
        engine (e.g. DiskEngine over a tmp dir for crash/stall chaos
        schedules); default MemoryEngine."""
        self.pd = pd if pd is not None else MockPd()
        self.transport = SimTransport()
        self.stores: dict[int, RaftStore] = {}
        self.engines: dict[int, MemoryEngine] = {}
        self.kvs: dict[int, RaftKv] = {}
        for i in range(1, n_stores + 1):
            engine = engine_factory(i) if engine_factory is not None \
                else MemoryEngine()
            store = RaftStore(i, engine, self.transport, seed=seed)
            store.observers = [self._on_region_changed]
            self.engines[i] = engine
            self.stores[i] = store
            self.transport.stores[i] = store
            self.kvs[i] = RaftKv(store, driver=self._drive_until)
            self.pd.put_store(Store(i))

    # ------------------------------------------------------------- bootstrap

    def bootstrap(self) -> Region:
        """Create region 1 spanning the whole keyspace on every store."""
        peers = tuple(Peer(100 + sid, sid) for sid in self.stores)
        region = Region(1, b"", b"", RegionEpoch(1, 1), peers)
        for store in self.stores.values():
            store.bootstrap_region(region)
        first = Store(1)
        self.pd.bootstrap_cluster(first, region)
        return region

    def start(self) -> None:
        self.elect_leader(1, 1)

    # ------------------------------------------------------------- driving

    def pump(self, max_rounds: int = 200) -> None:
        """Process messages + ready work until quiescent."""
        for _ in range(max_rounds):
            n = 0
            for store in self.stores.values():
                n += store.drive()
            n += self.transport.route_all()
            if n == 0:
                self.heartbeat_pd()
                return
        raise RuntimeError("cluster did not quiesce")

    def heartbeat_pd(self) -> None:
        """Leader peers report to PD (worker/pd.rs heartbeat loop), their
        split checker's bucket bounds with them."""
        for sid, store in self.stores.items():
            for peer in store.peers_snapshot():
                if peer.is_leader():
                    self.pd.region_heartbeat(
                        peer.region, Peer(peer.meta.id, sid),
                        buckets=list(peer.buckets))

    def tick_all(self, times: int = 1) -> None:
        for _ in range(times):
            for store in self.stores.values():
                store.tick()
            self.pump()

    def _drive_until(self, done: Callable[[], bool]) -> None:
        for _ in range(500):
            if done():
                return
            self.pump()
            if done():
                return
            self.tick_all()
        raise TimeoutError("cluster command stalled")

    # ------------------------------------------------------------- helpers

    def elect_leader(self, region_id: int, store_id: int) -> None:
        peer = self.stores[store_id].region_peer(region_id)
        peer.node.campaign(force=True)
        self.pump()
        assert peer.is_leader(), "election failed"

    def leader_store(self, region_id: int) -> Optional[int]:
        best = None
        best_term = -1
        for sid, store in self.stores.items():
            peer = store.peers.get(region_id)
            if peer is not None and peer.is_leader() and \
                    peer.node.term > best_term:
                best, best_term = sid, peer.node.term
        return best

    def leader_peer(self, region_id: int):
        sid = self.leader_store(region_id)
        return None if sid is None else \
            self.stores[sid].region_peer(region_id)

    def region_for(self, key: bytes, store_id: Optional[int] = None):
        sid = store_id
        if sid is None:
            for cand, store in self.stores.items():
                try:
                    store.peer_by_key(key)
                    sid = cand
                    break
                except Exception:
                    continue
        return self.stores[sid].peer_by_key(key)

    def _on_region_changed(self, store_id: int, region: Region) -> None:
        peer = self.stores[store_id].peers.get(region.id)
        if peer is not None and peer.is_leader():
            self.pd.region_heartbeat(region, Peer(peer.meta.id, store_id))

    # -- KV conveniences (node-simulator style must_put/must_get) --

    def _leader_kv_for(self, key: bytes):
        best = None
        best_term = -1
        for sid, store in self.stores.items():
            try:
                peer = store.peer_by_key(key)
            except Exception:
                continue
            if peer.is_leader() and peer.node.term > best_term:
                best, best_term = (self.kvs[sid], peer), peer.node.term
        if best is None:
            raise NotLeaderError(0)
        return best

    def must_put(self, key: bytes, value: bytes,
                 cf: str = CF_DEFAULT) -> None:
        from ..kv.engine import SnapContext, WriteData
        kv, peer = self._leader_kv_for(key)
        kv.write(SnapContext(region_id=peer.region.id),
                 WriteData([("put", cf, key, value)]))

    def txn_write(self, mutations, start_ts: int = 0,
                  commit_ts: int = 0) -> int:
        """Batched 2PC write helper: ONE Prewrite command carrying every
        mutation and ONE Commit over all keys, instead of per-row
        round trips (the reference's test_raftstore must_kv_prewrite /
        must_kv_commit pair).  ``mutations``: [(op, key, value|None)]
        with txn-layer user keys (e.g. encode_table_row output).
        Returns the commit_ts."""
        from ..raftstore import RaftKv
        from ..storage import Storage
        from ..storage.txn import commands as cmds
        from ..storage.txn.actions import Mutation
        assert mutations
        primary = mutations[0][1]
        sid = None
        from ..storage.txn_types import encode_key
        for cand, store in self.stores.items():
            try:
                peer = store.peer_by_key(encode_key(primary))
            except Exception:   # noqa: BLE001 — store lacks the region
                continue
            if peer.is_leader():
                sid = cand
                break
        assert sid is not None, "no leader for txn_write"
        st = Storage(RaftKv(self.stores[sid], driver=self._drive_until))
        start_ts = start_ts or self.pd.tso()
        st.sched_txn_command(cmds.Prewrite(
            [Mutation(op, key, value) for op, key, value in mutations],
            primary, start_ts))
        commit_ts = commit_ts or self.pd.tso()
        st.sched_txn_command(cmds.Commit(
            [key for _op, key, _v in mutations], start_ts, commit_ts))
        return commit_ts

    def must_get(self, key: bytes, cf: str = CF_DEFAULT):
        from ..kv.engine import SnapContext
        kv, peer = self._leader_kv_for(key)
        snap = kv.snapshot(SnapContext(region_id=peer.region.id))
        return snap.get_value_cf(cf, key)

    def get_on_store(self, store_id: int, key: bytes,
                     cf: str = CF_DEFAULT):
        """Read the applied state directly from one store's engine."""
        return self.engines[store_id].get_value_cf(cf, data_key(key))

    # -- admin --

    def split_region(self, region_id: int, split_key: bytes) -> Region:
        peer = self.leader_peer(region_id)
        assert peer is not None
        new_id, new_peer_ids = self.pd.ask_split(peer.region)
        cmd = RaftCmd(region_id, peer.region.epoch, admin=AdminCmd(
            "split", split_key=split_key, new_region_id=new_id,
            new_peer_ids=tuple(new_peer_ids)))
        box: dict = {}
        peer.propose(cmd, lambda r: box.__setitem__("result", r))
        self._drive_until(lambda: "result" in box)
        if isinstance(box["result"], Exception):
            raise box["result"]
        return box["result"]["right"]

    def check_consistency(self, region_id: int) -> int:
        """Consistency check round (worker/consistency_check.rs): propose
        ComputeHash, then VerifyHash with the leader's digest.  Every
        replica that applies VerifyHash compares its own digest; a
        diverged replica raises InconsistentRegion out of the drive loop.
        Returns the checked hash."""
        peer = self.leader_peer(region_id)
        assert peer is not None
        box: dict = {}
        # pin the cluster GC safe point into the proposal: replicas
        # hash only versions above it, so node-local compaction-filter
        # GC timing cannot fake a divergence
        sp = self.pd.get_gc_safe_point()
        peer.propose(RaftCmd(region_id, peer.region.epoch,
                             admin=AdminCmd(
                                 "compute_hash",
                                 extra=struct.pack(">Q", sp))),
                     lambda r: box.__setitem__("computed", r))
        self._drive_until(lambda: "computed" in box)
        if isinstance(box["computed"], Exception):
            raise box["computed"]
        got = box["computed"]["compute_hash"]
        index, digest = got["index"], got["hash"]
        peer.propose(RaftCmd(region_id, peer.region.epoch,
                             admin=AdminCmd(
                                 "verify_hash",
                                 extra=struct.pack(">QI", index, digest))),
                     lambda r: box.__setitem__("verified", r))
        self._drive_until(lambda: "verified" in box)
        if isinstance(box["verified"], Exception):
            raise box["verified"]
        # the leader's own apply passed; drain remaining routing so every
        # follower applies VerifyHash too (divergence raises here)
        self.pump()
        return digest

    def change_peers_joint(self, region_id: int, changes) -> None:
        """Atomic multi-peer change via joint consensus (raft §6;
        reference: test_joint_consensus.rs).  ``changes``: list of
        (change_type, Peer)."""
        from ..raftstore.cmd import encode_change_peer_v2
        peer = self.leader_peer(region_id)
        assert peer is not None
        cmd = RaftCmd(region_id, peer.region.epoch, admin=AdminCmd(
            "change_peer_v2", extra=encode_change_peer_v2(changes)))
        box: dict = {}
        peer.propose(cmd, lambda r: box.__setitem__("result", r))
        self._drive_until(lambda: "result" in box)
        if isinstance(box["result"], Exception):
            raise box["result"]
        # drive until the auto-leave applied everywhere (joint cleared)
        def left_joint():
            return all(not s.peers[region_id].node.in_joint()
                       for s in self.stores.values()
                       if region_id in s.peers)
        self._drive_until(left_joint)

    def change_peer(self, region_id: int, change_type: str,
                    peer_meta: Peer) -> None:
        peer = self.leader_peer(region_id)
        assert peer is not None
        cmd = RaftCmd(region_id, peer.region.epoch, admin=AdminCmd(
            "change_peer", change_type=change_type, peer=peer_meta))
        box: dict = {}
        peer.propose(cmd, lambda r: box.__setitem__("result", r))
        self._drive_until(lambda: "result" in box)
        if isinstance(box["result"], Exception):
            raise box["result"]

    def merge_region(self, source_id: int, target_id: int) -> Region:
        """PD-style coordinated merge (SURVEY §2.8.1): PrepareMerge on
        the source, wait until EVERY source peer applied it, then
        CommitMerge on the adjacent target.  Returns the merged region.
        """
        from ..raftstore.peer_storage import encode_region
        src = self.leader_peer(source_id)
        tgt = self.leader_peer(target_id)
        assert src is not None and tgt is not None
        s_stores = sorted(p.store_id for p in src.region.peers)
        t_stores = sorted(p.store_id for p in tgt.region.peers)
        assert s_stores == t_stores, "merge requires colocated replicas"
        sr, tr = src.region, tgt.region
        assert (sr.end_key and sr.end_key == tr.start_key) or \
            (tr.end_key and tr.end_key == sr.start_key), \
            "merge requires adjacent regions"
        # 1. PrepareMerge on the source
        box: dict = {}
        cmd = RaftCmd(source_id, sr.epoch, admin=AdminCmd(
            "prepare_merge", new_region_id=target_id))
        src.propose(cmd, lambda r: box.__setitem__("r", r))
        self._drive_until(lambda: "r" in box)
        if isinstance(box["r"], Exception):
            raise box["r"]
        prepare_index = box["r"]["prepare_index"]
        source_region = box["r"]["region"]

        # 2. every source peer must have applied the prepare
        def all_applied() -> bool:
            return all(
                store.peers[source_id].node.applied >= prepare_index
                for store in self.stores.values()
                if source_id in store.peers)
        self._drive_until(all_applied)

        # 3. CommitMerge on the target
        box2: dict = {}
        cmd2 = RaftCmd(target_id, tgt.region.epoch, admin=AdminCmd(
            "commit_merge", merge_index=prepare_index,
            extra=encode_region(source_region)))
        tgt.propose(cmd2, lambda r: box2.__setitem__("r", r))
        self._drive_until(lambda: "r" in box2)
        if isinstance(box2["r"], Exception):
            raise box2["r"]
        self.pump()
        return box2["r"]["region"]

    def split_check_all(self) -> int:
        """Run the size-based split checker on every store (the split
        check tick, store/worker/split_check.rs)."""
        n = 0
        for store in self.stores.values():
            n += store.split_check(self.pd)
        self.pump()
        return n

    def transfer_leader(self, region_id: int, to_store: int) -> None:
        peer = self.leader_peer(region_id)
        target = self.stores[to_store].region_peer(region_id)
        peer.node.transfer_leader(target.meta.id)
        self.pump()

    # -- fault injection (transport_simulate.rs filter conveniences) --

    def partition(self, group_a, group_b):
        """Symmetric partition between two store groups → the filter
        (pass to heal() to lift just this one)."""
        a, b = set(group_a), set(group_b)

        def filt(frm, to, _rid, _msg):
            return not ((frm in a and to in b) or (frm in b and to in a))
        self.transport.filters.append(filt)
        return filt

    def partition_oneway(self, from_group, to_group):
        """Asymmetric partition: messages FROM from_group TO to_group
        are dropped; the reverse direction still delivers."""
        a, b = set(from_group), set(to_group)

        def filt(frm, to, _rid, _msg):
            return not (frm in a and to in b)
        self.transport.filters.append(filt)
        return filt

    def isolate_store(self, store_id: int):
        def filt(frm, to, _rid, _msg):
            return frm != store_id and to != store_id
        self.transport.filters.append(filt)
        return filt

    def heal(self, filt=None) -> None:
        if filt is None:
            self.transport.filters.clear()
        elif filt in self.transport.filters:
            self.transport.filters.remove(filt)

    def stop_store(self, store_id: int) -> None:
        self.transport.stores.pop(store_id, None)
        self.stores.pop(store_id)
        self.kvs.pop(store_id)

    def restart_store(self, store_id: int, seed: int = 0) -> None:
        """Recreate a store over its surviving engine (crash recovery)."""
        engine = self.engines[store_id]
        store = RaftStore(store_id, engine, self.transport, seed=seed)
        store.observers = [self._on_region_changed]
        store.load_peers()
        self.stores[store_id] = store
        self.transport.stores[store_id] = store
        self.kvs[store_id] = RaftKv(store, driver=self._drive_until)
