"""PD client trait + in-memory mock.

A trimmed copy of the JAX package's ``pd/client.py``: ``PdClient`` and
``MockPd`` with the bookkeeping one store needs (bootstrap, ids, stores,
regions and their heartbeats, store heartbeats and the TSO).  Not here:
split ids, the GC safe point, the cluster version, the balance scheduler
and its operators, replica-feed placement in the store-heartbeat
response, buckets and the hot-region report.

Reference: components/pd_client/src/lib.rs PdClient (bootstrap_cluster,
alloc_id, region_heartbeat :418, ask_batch_split :446, store_heartbeat
:455, get_gc_safe_point :484, TSO tso.rs) and the in-memory test PD
(components/test_raftstore/src/pd.rs) whose parity SURVEY.md §4 requires.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional, Protocol, Sequence

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

    def store_heartbeat(self, store_id: int,
                        stats: dict) -> Optional[dict]: ...

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
        self._tso_physical = 1
        self._tso_logical = 0
        self.store_stats: dict[int, dict] = {}

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

    def region_heartbeat(self, region: Region, leader: Peer,
                         buckets=None):
        """Reference: pd.rs handle_heartbeat — accept newer epochs only;
        a newer region covering an older one's whole range evicts it.
        Returns the scheduling operator step: None, as no scheduler runs
        here."""
        with self._lock:
            cur = self._regions.get(region.id)
            if cur is not None:
                ce, ne = cur.region.epoch, region.epoch
                if (ne.version, ne.conf_ver) < (ce.version, ce.conf_ver):
                    return None     # stale heartbeat
            self._regions[region.id] = _RegionInfo(region, leader)
            for rid, info in list(self._regions.items()):
                if rid == region.id:
                    continue
                o = info.region
                covered = o.start_key >= region.start_key and (
                    not region.end_key or
                    (o.end_key and o.end_key <= region.end_key))
                if covered and (o.epoch.version < region.epoch.version):
                    del self._regions[rid]
            return None

    def store_heartbeat(self, store_id: int, stats: dict
                        ) -> Optional[dict]:
        """Record store stats (kvproto StoreHeartbeatResponse carries no
        operator here)."""
        with self._lock:
            self.store_stats[store_id] = stats
        return None

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
