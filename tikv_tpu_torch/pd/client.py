"""PD client trait + in-memory mock.

A trimmed copy of the JAX package's ``pd/client.py``: ``PdClient`` and
``MockPd`` with the bookkeeping the stores of one cluster need
(bootstrap, ids, stores, regions, their leaders and buckets from the
heartbeats, split ids, store heartbeats, the GC safe point and the TSO).
Not here: the cluster version, the balance scheduler and its operators,
replica-feed placement in the store-heartbeat response, the hot-region
report and batched TSO.

Reference: components/pd_client/src/lib.rs PdClient (bootstrap_cluster,
alloc_id, region_heartbeat :418, ask_batch_split :446, store_heartbeat
:455, get_gc_safe_point :484, TSO tso.rs) and the in-memory test PD
(components/test_raftstore/src/pd.rs) whose parity SURVEY.md §4 requires.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional, Protocol

from ..raftstore.metapb import Peer, Region, Store
from ..storage.txn_types import compose_ts


class PdClient(Protocol):
    def bootstrap_cluster(self, store: Store, region: Region) -> None: ...

    def is_bootstrapped(self) -> bool: ...

    def alloc_id(self) -> int: ...

    def put_store(self, store: Store) -> None: ...

    def get_store(self, store_id: int) -> Store: ...

    def get_region(self, key: bytes) -> Region: ...

    def get_region_by_id(self, region_id: int) -> Optional[Region]: ...

    def region_heartbeat(self, region: Region, leader: Peer,
                         buckets=None) -> Optional[dict]: ...

    def ask_split(self, region: Region) -> tuple[int, list[int]]: ...

    def store_heartbeat(self, store_id: int,
                        stats: dict) -> Optional[dict]: ...

    def get_gc_safe_point(self) -> int: ...

    def tso(self) -> int: ...


@dataclass
class _RegionInfo:
    region: Region
    leader: Optional[Peer] = None


class MockPd:
    """In-memory PD with the bookkeeping the store workers expect."""

    def __init__(self):
        self._lock = threading.Lock()
        self._next_id = 1000
        self._stores: dict[int, Store] = {}
        self._regions: dict[int, _RegionInfo] = {}
        self._bootstrapped = False
        self._safe_point = 0
        self._tso_physical = 1
        self._tso_logical = 0
        self.store_stats: dict[int, dict] = {}
        # region buckets: sub-range split points for finer coprocessor
        # parallelism (pd_client/src/lib.rs:118-240)
        self._buckets: dict[int, list] = {}

    # -- lifecycle --

    def bootstrap_cluster(self, store: Store, region: Region) -> None:
        with self._lock:
            assert not self._bootstrapped
            self._bootstrapped = True
            self._stores[store.id] = store
            self._regions[region.id] = _RegionInfo(region)

    def is_bootstrapped(self) -> bool:
        return self._bootstrapped

    def alloc_id(self) -> int:
        with self._lock:
            self._next_id += 1
            return self._next_id

    # -- stores --

    def put_store(self, store: Store) -> None:
        with self._lock:
            self._stores[store.id] = store

    def get_store(self, store_id: int) -> Store:
        return self._stores[store_id]

    def stores(self) -> list[Store]:
        return list(self._stores.values())

    # -- regions --

    def get_region(self, key: bytes) -> Region:
        with self._lock:
            for info in self._regions.values():
                if info.region.contains(key):
                    return info.region
        raise KeyError(f"no region for {key!r}")

    def get_region_by_id(self, region_id: int) -> Optional[Region]:
        info = self._regions.get(region_id)
        return info.region if info else None

    def leader_of(self, region_id: int) -> Optional[Peer]:
        info = self._regions.get(region_id)
        return info.leader if info else None

    def region_heartbeat(self, region: Region, leader: Peer,
                         buckets=None):
        """Reference: pd.rs handle_heartbeat — accept newer epochs only;
        a newer region covering an older one's whole range evicts it
        (how PD learns a merge: the absorbed source simply vanishes).
        Returns the scheduling operator step: None, as no scheduler runs
        here."""
        with self._lock:
            cur = self._regions.get(region.id)
            if cur is not None:
                ce, ne = cur.region.epoch, region.epoch
                if (ne.version, ne.conf_ver) < (ce.version, ce.conf_ver):
                    return None     # stale heartbeat
            self._regions[region.id] = _RegionInfo(region, leader)
            if buckets is not None:
                self._buckets[region.id] = list(buckets)
            for rid, info in list(self._regions.items()):
                if rid == region.id:
                    continue
                o = info.region
                covered = o.start_key >= region.start_key and (
                    not region.end_key or
                    (o.end_key and o.end_key <= region.end_key))
                if covered and (o.epoch.version < region.epoch.version):
                    del self._regions[rid]
                    # the absorbed region never heartbeats again
                    self._buckets.pop(rid, None)
            return None

    def get_buckets(self, region_id: int) -> list:
        """Sub-region bucket boundaries (pd_client buckets API)."""
        return list(self._buckets.get(region_id, ()))

    def ask_split(self, region: Region) -> tuple[int, list[int]]:
        """→ (new_region_id, new peer ids aligned with region.peers)."""
        with self._lock:
            self._next_id += 1
            new_region_id = self._next_id
            ids = []
            for _ in region.peers:
                self._next_id += 1
                ids.append(self._next_id)
            return new_region_id, ids

    def store_heartbeat(self, store_id: int, stats: dict
                        ) -> Optional[dict]:
        """Record store stats (kvproto StoreHeartbeatResponse carries no
        operator here)."""
        with self._lock:
            self.store_stats[store_id] = stats
        return None

    def set_gc_safe_point(self, ts: int) -> None:
        self._safe_point = ts

    def get_gc_safe_point(self) -> int:
        return self._safe_point

    def tso(self) -> int:
        """Monotonic timestamp oracle (pd_client/src/tso.rs): physical =
        wall-clock ms (lock TTLs are measured against it), logical breaks
        ties within one millisecond."""
        import time
        with self._lock:
            physical = int(time.time() * 1000)
            if physical > self._tso_physical:
                self._tso_physical = physical
                self._tso_logical = 0
            else:
                self._tso_logical += 1
                if self._tso_logical >= (1 << 18):
                    self._tso_physical += 1
                    self._tso_logical = 0
            return compose_ts(self._tso_physical, self._tso_logical)
