"""PD as a service + remote PD client.

A copy of the JAX package's ``server/pd_server.py`` over the port's
``MockPd``: ``PdService``, ``PdServer`` (``stop`` joins its handler pool)
and ``RemotePdClient``.  The methods ``MockPd`` lacks — ``HotRegions``,
``GetClusterVersion`` and a ``Tso`` of more than one timestamp (the
client's ``tso_batch``) — are refused by name.

Reference: PD is an external process the reference talks to through
components/pd_client (gRPC with reconnect, util.rs).  Here the in-memory
MockPd is exposed over gRPC so multi-process clusters share one control
plane; RemotePdClient implements the same PdClient protocol the Node and
tools consume.
"""

from __future__ import annotations

from concurrent import futures
from typing import Optional

from ..pd.client import MockPd
from ..raftstore.metapb import Store
from . import wire


# PD methods of the reference the port's MockPd has no state for, by name
# → what each waits for
_REFUSED = {
    "HotRegions": "the resource-metering report on store heartbeats",
    "GetClusterVersion": "the cluster version and the feature gate",
}


class PdService:
    def __init__(self, pd: MockPd):
        self.pd = pd

    def handle(self, method: str, req: dict) -> dict:
        if method in _REFUSED:
            return {"error": {"kind": "unimplemented", "method": method,
                              "waits_for": _REFUSED[method]}}
        fn = getattr(self, method, None)
        if fn is None or method.startswith("_") or \
                not method[:1].isupper():
            return {"error": {"kind": "unimplemented", "method": method}}
        try:
            return fn(req)
        except Exception as e:      # noqa: BLE001
            return {"error": {"kind": "other", "message": str(e)}}

    def Bootstrap(self, req: dict) -> dict:
        self.pd.bootstrap_cluster(
            Store(req["store"]["id"], req["store"]["address"]),
            wire.dec_region(req["region"]))
        return {}

    def IsBootstrapped(self, req: dict) -> dict:
        return {"bootstrapped": self.pd.is_bootstrapped()}

    def AllocId(self, req: dict) -> dict:
        return {"id": self.pd.alloc_id()}

    def PutStore(self, req: dict) -> dict:
        self.pd.put_store(Store(req["id"], req["address"]))
        return {}

    def GetStore(self, req: dict) -> dict:
        s = self.pd.get_store(req["id"])
        return {"id": s.id, "address": s.address}

    def GetAllStores(self, req: dict) -> dict:
        return {"stores": [{"id": s.id, "address": s.address}
                           for s in self.pd.stores()]}

    def GetRegion(self, req: dict) -> dict:
        r = self.pd.get_region(req["key"])
        leader = self.pd.leader_of(r.id)
        return {"region": wire.enc_region(r),
                "leader": wire.enc_peer(leader) if leader else None}

    def GetRegionById(self, req: dict) -> dict:
        r = self.pd.get_region_by_id(req["region_id"])
        if r is None:
            return {"region": None, "leader": None}
        leader = self.pd.leader_of(r.id)
        return {"region": wire.enc_region(r),
                "leader": wire.enc_peer(leader) if leader else None}

    def RegionHeartbeat(self, req: dict) -> dict:
        op = self.pd.region_heartbeat(wire.dec_region(req["region"]),
                                      wire.dec_peer(req["leader"]),
                                      buckets=req.get("buckets"))
        return {"operator": op}

    def AskSplit(self, req: dict) -> dict:
        new_id, peer_ids = self.pd.ask_split(wire.dec_region(req["region"]))
        return {"new_region_id": new_id, "new_peer_ids": peer_ids}

    def StoreHeartbeat(self, req: dict) -> dict:
        resp = self.pd.store_heartbeat(req["store_id"],
                                       req.get("stats", {}))
        return resp or {}

    def GetGcSafePoint(self, req: dict) -> dict:
        return {"safe_point": self.pd.get_gc_safe_point()}

    def UpdateGcSafePoint(self, req: dict) -> dict:
        self.pd.set_gc_safe_point(req["safe_point"])
        return {"safe_point": self.pd.get_gc_safe_point()}

    def Tso(self, req: dict) -> dict:
        if req.get("count", 1) != 1:
            return {"error": {"kind": "unimplemented", "method": "Tso",
                              "waits_for": "batched TSO (tso_batch)"}}
        return {"ts": [self.pd.tso()]}


class PdServer:
    def __init__(self, addr: str, pd: Optional[MockPd] = None):
        self.pd = pd if pd is not None else MockPd()
        # held so stop() can join the (non-daemon) handler workers —
        # same leak-per-cycle rationale as TikvServer
        self._pool = futures.ThreadPoolExecutor(max_workers=4)
        from .security import bind_port, make_server
        from .server import _GenericHandler
        self._server = make_server(self._pool)
        self._server.add_generic_rpc_handlers((
            _GenericHandler("/pd.PD/", PdService(self.pd).handle),))
        self.port = bind_port(self._server, addr)
        assert self.port, f"cannot bind {addr}"

    def start(self) -> None:
        self._server.start()

    def stop(self, grace=0.5) -> None:
        self._server.stop(grace).wait()
        self._pool.shutdown(wait=True)

    def wait(self) -> None:
        self._server.wait_for_termination()


class RemotePdClient:
    """PdClient protocol over the PD gRPC service (pd_client parity)."""

    def __init__(self, addr: str):
        from .security import make_channel
        self._chan = make_channel(addr)

    def _call(self, method: str, req: dict) -> dict:
        fn = self._chan.unary_unary(
            "/pd.PD/" + method, request_serializer=wire.pack,
            response_deserializer=wire.unpack)
        resp = fn(req, timeout=10)
        if resp.get("error"):
            raise wire.RemoteError(resp["error"])
        return resp

    def bootstrap_cluster(self, store, region) -> None:
        self._call("Bootstrap", {
            "store": {"id": store.id, "address": store.address},
            "region": wire.enc_region(region)})

    def is_bootstrapped(self) -> bool:
        return self._call("IsBootstrapped", {})["bootstrapped"]

    def alloc_id(self) -> int:
        return self._call("AllocId", {})["id"]

    def put_store(self, store) -> None:
        self._call("PutStore", {"id": store.id, "address": store.address})

    def get_store(self, store_id: int):
        r = self._call("GetStore", {"id": store_id})
        return Store(r["id"], r["address"])

    def stores(self):
        return [Store(s["id"], s["address"])
                for s in self._call("GetAllStores", {})["stores"]]

    def get_region(self, key: bytes):
        return wire.dec_region(self._call("GetRegion", {"key": key})["region"])

    def get_region_with_leader(self, key: bytes):
        r = self._call("GetRegion", {"key": key})
        return wire.dec_region(r["region"]), wire.dec_peer(r["leader"])

    def get_region_by_id(self, region_id: int):
        r = self._call("GetRegionById", {"region_id": region_id})
        return wire.dec_region(r["region"]) if r["region"] else None

    def region_heartbeat(self, region, leader, buckets=None):
        r = self._call("RegionHeartbeat",
                       {"region": wire.enc_region(region),
                        "leader": wire.enc_peer(leader),
                        "buckets": buckets})
        return r.get("operator")

    def ask_split(self, region):
        r = self._call("AskSplit", {"region": wire.enc_region(region)})
        return r["new_region_id"], r["new_peer_ids"]

    def store_heartbeat(self, store_id: int, stats: dict):
        return self._call("StoreHeartbeat",
                          {"store_id": store_id, "stats": stats})

    def get_gc_safe_point(self) -> int:
        return self._call("GetGcSafePoint", {})["safe_point"]

    def set_gc_safe_point(self, ts: int) -> None:
        self._call("UpdateGcSafePoint", {"safe_point": ts})

    def tso(self) -> int:
        return self._call("Tso", {})["ts"][0]

    def close(self) -> None:
        self._chan.close()
