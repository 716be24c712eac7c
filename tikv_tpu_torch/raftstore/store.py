"""RaftStore — all the peers living on one store.

A trimmed copy of the JAX package's ``raftstore/store.py`` for a single
store: peers are bootstrapped or reloaded from the engine and driven by
the synchronous ``drive()`` loop.  Not here: the batch-system poller
pools, the split checker and split-peer creation, peer destruction, the
health controller and the fail-slow knobs.

Reference: components/raftstore/src/store/fsm/store.rs (StoreFsm +
store meta: region ranges → peers) and fsm/peer.rs message dispatch; the
batch-system actor runtime (components/batch-system) is collapsed into a
synchronous ``drive()`` loop — the reference's poll loop shape
(batch.rs:340) without threads.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..engine.traits import CF_RAFT, KvEngine
from ..raft.messages import Message
from .metapb import Peer as PeerMeta, Region, RegionNotFound
from .observer import CoprocessorHost
from .peer import RaftPeer
from .peer_storage import REGION_PREFIX, decode_region


class Transport:
    """Store-to-store raft message channel.

    Reference: src/server/raft_client.rs (buffered per-peer connections)
    — here an interface.  ``send(to_store, region_id, to_peer, from_peer,
    msg)``.  A single store's peers have no one to send to: the base
    class drops nothing silently, it refuses.
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
        # observer host: the delta sink, the cold stream and the device
        # supervisor hook the apply path here (coprocessor/mod.rs:98-594)
        self.coprocessor_host = CoprocessorHost()
        # guards self.peers mutations against iteration from other threads
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

    def _add_peer(self, region: Region, meta: PeerMeta,
                  initial: bool = False) -> RaftPeer:
        peer = RaftPeer(self, region, meta, self.engine, initial=initial,
                        **self._raft_cfg)
        with self.meta_mu:
            self.peers[region.id] = peer
        return peer

    def peers_snapshot(self) -> list:
        """Stable peer list for iteration from any thread."""
        with self.meta_mu:
            return list(self.peers.values())

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

    # ------------------------------------------------------------- messages

    def on_raft_message(self, region_id: int, to_peer: PeerMeta,
                        from_peer: PeerMeta, msg: Message) -> None:
        """Step a raft message into the addressed peer.  A message for a
        region this store does not hold is dropped: on one store it can
        only be stale, since no other store adds a peer here."""
        from ..utils.failpoint import fail_point
        # a "return" action models inbound message loss at this store
        if fail_point("store::drop_raft_message") is not None:
            return
        fail_point("store::on_raft_message")
        peer = self.peers.get(region_id)
        if peer is None or to_peer.id != peer.meta.id:
            return      # unknown region or stale peer id
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
            for msg in peer.handle_ready():
                target = self._peer_meta(peer.region, msg.to) or \
                    peer.peer_cache.get(msg.to)
                if target is None:
                    continue
                self.transport.send(target.store_id, region_id, target,
                                    peer.meta, msg)
                sent += 1
        return sent

    @staticmethod
    def _peer_meta(region: Region, peer_id: int) -> Optional[PeerMeta]:
        for p in region.peers:
            if p.id == peer_id:
                return p
        return None

