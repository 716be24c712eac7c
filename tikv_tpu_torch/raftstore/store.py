"""RaftStore — all the peers living on one store.

A copy of the JAX package's ``raftstore/store.py`` for stores driven
synchronously: peers are bootstrapped, reloaded from the engine, created
on a raft message for a region the store does not hold (an uninitialized
shell that a leader snapshot then initializes — store/fsm/store.rs
maybe_create_peer), created by a split (``create_split_peer``) and
destroyed on conf-change removal or merge (``destroy_peer``); the
synchronous ``drive()`` loop pumps them, and the split checker
(``split_check``, store/worker/split_check.rs) proposes size-based
half-splits.  Not here: the batch-system poller pools and the apply pool,
the health controller and the fail-slow knobs.

Reference: components/raftstore/src/store/fsm/store.rs (StoreFsm +
store meta: region ranges → peers) and fsm/peer.rs message dispatch; the
batch-system actor runtime (components/batch-system) is collapsed into a
synchronous ``drive()`` loop — the reference's poll loop shape
(batch.rs:340) without threads, which the in-process cluster fixture and
the node both pump.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from ..config import RaftstoreConfig
from ..engine.traits import CF_DEFAULT, CF_LOCK, CF_RAFT, CF_WRITE, KvEngine
from ..raft.messages import Message, MsgType
from .cmd import AdminCmd, RaftCmd
from .metapb import Peer as PeerMeta, Region, RegionNotFound
from .observer import CoprocessorHost
from .peer import RaftPeer
from .peer_storage import REGION_PREFIX, decode_region, region_data_bounds


class Transport:
    """Store-to-store raft message channel.

    Reference: src/server/raft_client.rs (buffered per-peer connections)
    — here an interface; the in-process cluster provides one
    (``testing.cluster.SimTransport``).  ``send(to_store, region_id,
    to_peer, from_peer, msg)``.  A store with no other store to reach
    keeps this base class: it drops nothing silently, it refuses.
    """

    def send(self, to_store: int, region_id: int, to_peer: PeerMeta,
             from_peer: PeerMeta, msg: Message) -> None:
        raise RuntimeError(
            f"region {region_id}: no transport to store {to_store}")


class RaftStore:
    def __init__(self, store_id: int, engine: KvEngine,
                 transport: Transport, election_tick: int = 10,
                 heartbeat_tick: int = 2, pre_vote: bool = True,
                 seed: int = 0, tick_interval: float | None = None):
        self.store_id = store_id
        self.engine = engine
        self.transport = transport
        self.peers: dict[int, RaftPeer] = {}
        self._raft_cfg = dict(election_tick=election_tick,
                              heartbeat_tick=heartbeat_tick,
                              pre_vote=pre_vote, seed=seed,
                              tick_interval=tick_interval)
        self._campaign_on_create: set[int] = set()
        # live raftstore knobs (split thresholds); the node swaps in the
        # config-file section
        self.config = RaftstoreConfig()
        # observer host: the delta sink, the cold stream and the device
        # supervisor hook the apply path here (coprocessor/mod.rs:98-594)
        self.coprocessor_host = CoprocessorHost()
        # region-change callbacks (store_id, region): the cluster fixture
        # reports the new region to PD through one
        self.observers: list = []
        # guards self.peers mutations: splits, merges and conf changes
        # create and destroy peers while other threads iterate
        self.meta_mu = threading.Lock()

    # ------------------------------------------------------------- lifecycle

    def load_peers(self) -> None:
        """Restart path: recreate every peer persisted in the engine."""
        from ..utils.failpoint import fail_point
        fail_point("store::before_load_peers")
        it = self.engine.iterator_cf(
            CF_RAFT, REGION_PREFIX,
            REGION_PREFIX[:-1] + bytes([REGION_PREFIX[-1] + 1]))
        regions = []
        state_key_len = len(REGION_PREFIX) + 8 + 1
        ok = it.seek_to_first()
        while ok:
            k = it.key()
            # exact region_state_key shape: prefix + region_id(8) + "m".
            # A suffix check alone is wrong — raft_log_key ends with the
            # entry index whose low byte can be 0x6d ("m", e.g. index 109)
            if len(k) == state_key_len and k.endswith(b"m"):
                regions.append(decode_region(it.value()))
            ok = it.next()
        for region in regions:
            meta = region.peer_on_store(self.store_id)
            if meta is not None:
                self._add_peer(region, meta)

    def bootstrap_region(self, region: Region) -> None:
        """First-start path: persist + create the initial region's peer."""
        meta = region.peer_on_store(self.store_id)
        assert meta is not None, (region, self.store_id)
        peer = self._add_peer(region, meta, initial=True)
        wb = self.engine.write_batch()
        peer.peer_storage.write_initial_state(wb)
        peer.peer_storage.persist_region(wb, region)
        self.engine.write(wb)

    # set by the node: leader-side async-commit check for ReadIndex
    read_index_hook = None

    def _new_peer(self, region: Region, meta: PeerMeta,
                  initial: bool = False) -> RaftPeer:
        """THE single peer constructor: every creation path (bootstrap,
        restart load, split, shell-on-message) flows through here so
        per-peer wiring (the ReadIndex async-commit hook) exists in one
        place."""
        peer = RaftPeer(self, region, meta, self.engine, initial=initial,
                        **self._raft_cfg)
        if self.read_index_hook is not None:
            peer.node.read_index_hook = \
                (lambda ts, p=peer: self.read_index_hook(ts, p.region))
        return peer

    def _add_peer(self, region: Region, meta: PeerMeta,
                  initial: bool = False) -> RaftPeer:
        peer = self._new_peer(region, meta, initial=initial)
        with self.meta_mu:
            self.peers[region.id] = peer
        return peer

    def peers_snapshot(self) -> list:
        """Stable peer list for iteration from any thread."""
        with self.meta_mu:
            return list(self.peers.values())

    def create_split_peer(self, wb, right: Region,
                          was_leader: bool) -> None:
        """Apply-time creation of the right half of a split."""
        meta = right.peer_on_store(self.store_id)
        if meta is None or right.id in self.peers:
            return
        peer = self._add_peer(right, meta, initial=True)
        peer.peer_storage.write_initial_state(wb)
        peer.peer_storage.persist_region(wb, right)
        if was_leader:
            # the parent's leader store campaigns the new region at once
            # so it gets a leader without waiting an election timeout
            self._campaign_on_create.add(right.id)

    def destroy_peer(self, region_id: int) -> None:
        from ..utils.failpoint import fail_point
        fail_point("store::before_destroy_peer")
        with self.meta_mu:
            peer = self.peers.pop(region_id, None)
        if peer is not None:
            wb = self.engine.write_batch()
            peer.peer_storage.destroy(wb)
            self.engine.write(wb)
            # lifecycle teardown: subscribers (delta sink, device-state
            # supervisor) drop every artifact derived from this region
            self.coprocessor_host.notify_peer_destroyed(region_id)

    # ------------------------------------------------------------- routing

    def region_peer(self, region_id: int) -> RaftPeer:
        peer = self.peers.get(region_id)
        if peer is None:
            raise RegionNotFound(region_id)
        return peer

    def peer_by_key(self, key: bytes) -> RaftPeer:
        for peer in self.peers_snapshot():
            if peer.region.contains(key):
                return peer
        raise RegionNotFound(-1)

    def on_region_changed(self, peer: RaftPeer, region: Region) -> None:
        """Metadata hook (split/merge/conf change/snapshot) — the observer
        host's region-change event (raftstore/src/coprocessor)."""
        for obs in self.observers:
            obs(self.store_id, region)
        self.coprocessor_host.notify_region_changed(region)

    # ------------------------------------------------------------- messages

    def on_raft_message(self, region_id: int, to_peer: PeerMeta,
                        from_peer: PeerMeta, msg: Message) -> None:
        """Step a raft message into the addressed peer.  A message for a
        region this store does not hold creates an uninitialized shell
        peer when it can carry the region to it (an append, a heartbeat
        or a snapshot: add-peer or a slow split); any other is dropped."""
        from ..utils.failpoint import fail_point
        # a "return" action models inbound message loss at this store
        if fail_point("store::drop_raft_message") is not None:
            return
        fail_point("store::on_raft_message")
        peer = self.peers.get(region_id)
        if peer is None:
            if msg.msg_type not in (MsgType.APPEND, MsgType.HEARTBEAT,
                                    MsgType.SNAPSHOT):
                return
            # Empty peer list: the shell must NOT see itself as a voter,
            # else once leader contact lapses it self-elects in a
            # single-voter group and inflates terms (reference:
            # store/fsm/store.rs maybe_create_peer replicates with an
            # empty peer list; the leader snapshot installs the real
            # membership).  to_peer rides peer_cache/meta for routing.
            peer = self._add_peer(Region(region_id, peers=()), to_peer)
        if to_peer.id != peer.meta.id:
            return      # stale peer id
        peer.peer_cache[from_peer.id] = from_peer
        peer.step(msg)

    # ------------------------------------------------------------- driving

    def tick(self) -> None:
        for peer in self.peers_snapshot():
            peer.tick()

    def drive(self) -> int:
        """Handle all pending ready work; send messages.  Returns the
        number of messages sent (0 = quiescent)."""
        sent = 0
        for region_id in list(self.peers):
            peer = self.peers.get(region_id)
            if peer is None:
                continue
            if region_id in self._campaign_on_create:
                self._campaign_on_create.discard(region_id)
                peer.node.campaign(force=True)
            for msg in peer.handle_ready():
                target = self._peer_meta(peer.region, msg.to) or \
                    peer.peer_cache.get(msg.to)
                if target is None:
                    continue
                self.transport.send(target.store_id, region_id, target,
                                    peer.meta, msg)
                sent += 1
            if peer.pending_destroy:
                self.destroy_peer(region_id)
        return sent

    @staticmethod
    def _peer_meta(region: Region, peer_id: int) -> Optional[PeerMeta]:
        for p in region.peers:
            if p.id == peer_id:
                return p
        return None

    # ------------------------------------------------------- split checker

    def _scan_region(self, peer: RaftPeer):
        """ONE bulk pass over the region's data CFs → (total_bytes,
        ``ScanEntries``: the (bare key, bytes) candidates of CF_WRITE and
        CF_DEFAULT in (key, bytes) order) — size and split-key candidates
        from the same scan.  The reference reads RocksDB table-properties
        instead (engine_rocks/src/properties.rs); a scan is exact.  Bytes
        are counted in C (``map(len)``) and summed in numpy."""
        lo, hi = region_data_bounds(peer.region)
        total = 0
        parts = []
        for cf, splittable in ((CF_WRITE, True), (CF_DEFAULT, True),
                               (CF_LOCK, False)):
            keys, vals, _skip = self.engine.range_cf(cf, lo, hi)
            if not keys:
                continue
            sz = np.fromiter(map(len, keys), np.int64, len(keys)) + \
                np.fromiter(map(len, vals), np.int64, len(vals))
            total += int(sz.sum())
            if splittable:
                parts.append((keys, sz))
        return total, ScanEntries(parts)

    def region_approximate_size(self, peer: RaftPeer) -> int:
        return self._scan_region(peer)[0]

    def find_split_key(self, peer: RaftPeer,
                       entries=None) -> Optional[bytes]:
        """The key where cumulative size crosses half the region —
        worker/split_check.rs's half-split policy.  Versioned keys
        (txn keyspace 'x', 8-byte ts suffix in write/default CFs) are
        truncated to the bare encoded key so one user key's versions
        never straddle the boundary."""
        if entries is None:
            entries = self._scan_region(peer)[1]
        if len(entries) < 2:
            return None
        cum = entries.cumulative()
        region = peer.region
        # the first entry whose running total reaches half; walk on while
        # the key is the region's start (the midpoint may equal it)
        for i in range(int(np.searchsorted(cum, int(cum[-1]) // 2)),
                       len(entries)):
            uk = entries.key(i)
            if uk > region.start_key and \
                    (not region.end_key or uk < region.end_key):
                return uk
        return None

    def _bucket_bounds(self, entries) -> list:
        """Sub-region bucket boundaries every region_bucket_size_mb of
        data (pd_client buckets: finer copr parallelism units): the key
        at which the running total since the last bound reaches it."""
        bucket_bytes = int(self.config.region_bucket_size_mb * (1 << 20))
        if bucket_bytes <= 0 or not len(entries):
            return []
        cum = entries.cumulative()
        out = []
        base = 0
        while True:
            i = int(np.searchsorted(cum, base + bucket_bytes))
            if i >= len(entries):
                return out
            out.append(entries.key(i))
            base = int(cum[i])

    def split_check(self, pd) -> int:
        """One split-checker pass (store/worker/split_check.rs): leader
        peers over ``region_split_size_mb`` propose a half-split with
        PD-allocated ids.  One bulk scan per region serves the size
        estimate, the split key, AND the bucket bounds — but a region
        is only re-scanned once apply has accumulated
        ``region_split_check_diff`` bytes of changes since the last
        scan (fsm/apply.rs size_diff_hint): scanning every region every
        pass would cost seconds per tick at scale and contend every
        lease read.  Returns splits proposed."""
        threshold = int(self.config.region_split_size_mb * (1 << 20))
        if threshold <= 0:
            return 0
        # reference default: split-size/16 (coprocessor config
        # region_split_check_diff); bucket bounds also come from this
        # scan, so the finer of the two granularities drives the
        # re-check trigger.  Scales down with tiny test thresholds so
        # small fixtures still re-check promptly.
        bucket_bytes = int(self.config.region_bucket_size_mb * (1 << 20))
        gran = min(threshold, bucket_bytes) if bucket_bytes > 0 \
            else threshold
        check_diff = max(gran // 16, 1)
        proposed = 0
        for peer in self.peers_snapshot():
            if not peer.is_leader() or peer.merging is not None:
                continue
            if peer.size_diff_hint < check_diff:
                continue
            peer.size_diff_hint = 0
            size, entries = self._scan_region(peer)
            peer.approximate_size = size
            peer.buckets = self._bucket_bounds(entries)
            if size < threshold:
                continue
            split_key = self.find_split_key(peer, entries)
            if split_key is None:
                continue
            new_id, new_peer_ids = pd.ask_split(peer.region)
            cmd = RaftCmd(peer.region.id, peer.region.epoch,
                          admin=AdminCmd(
                              "split", split_key=split_key,
                              new_region_id=new_id,
                              new_peer_ids=tuple(new_peer_ids)))
            try:
                peer.propose(cmd, lambda r: None)
                proposed += 1
            except Exception:   # noqa: BLE001 — not leader anymore /
                continue        # epoch raced
        return proposed


class ScanEntries:
    """The split checker's candidates: the bare key of each CF_WRITE and
    CF_DEFAULT entry (data prefix stripped; a versioned key of the txn
    keyspace 'x' without its 8-byte ts, so one key's versions stay
    together) and its bytes, in the order the reference's sort of (bare
    key, bytes) pairs gives them: by key, then by bytes.

    ``parts``: (engine keys, key + value bytes) of each CF.  One CF's
    stripped keys are most often still in order, and then only a run of
    equal keys (one key's versions) is ordered, by its bytes."""

    def __init__(self, parts: list):
        uks: list = []
        for keys, _sz in parts:
            uks += [k[1:-8] if k[1:2] == b"x" and len(k) > 9 else k[1:]
                    for k in keys]
        sz = np.concatenate([p[1] for p in parts]) if parts else \
            np.zeros(0, np.int64)
        if len(parts) > 1 or not all(map(bytes.__le__, uks, uks[1:])):
            # stripped keys out of order: sort by key, bytes breaking ties
            order = sorted(np.argsort(sz, kind="stable").tolist(),
                           key=uks.__getitem__)
            uks = [uks[i] for i in order]
            sz = sz[order]
        elif len(uks) > 1:
            same = np.fromiter(map(bytes.__eq__, uks, uks[1:]), np.bool_,
                               len(uks) - 1)
            if same.any():
                run = np.concatenate([[0], np.cumsum(~same)])
                sz = sz[np.lexsort((sz, run))]
        self._uks = uks
        self.sizes = sz

    def __len__(self) -> int:
        return len(self.sizes)

    def key(self, i: int) -> bytes:
        return self._uks[i]

    def cumulative(self) -> np.ndarray:
        return np.cumsum(self.sizes)
