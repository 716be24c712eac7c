"""The port's networked server (``tikv_tpu_torch.server``: ``PdServer``,
three ``TikvServer``s, ``TxnClient``, raft between the stores over
``GrpcTransport``) against the JAX package's, each cluster real gRPC on
loopback.

One cluster of each package runs for the module, built as
``tests/test_server.py`` builds its own (one PD, three stores, region 1
given peers on stores 2 and 3 through ``add_peer``; every node with a
device runner and ``device_row_threshold=128``: the reference's shared
runner on JAX's CPU, the port's nodes a ``DeviceRunner(device="cpu")``
each).  Every case sends both clusters the same requests and holds the
port's answers to the reference's: ``test_server.py``'s network cases
(put and get with the rows on all three stores, multi-key 2PC, versions,
scan, lock resolution, a write conflict, raw, the coprocessor on the host
and on the device backend, concurrent coprocessor requests, split and
routing, lease reads and the read pool, store status, region metadata
alike on every store), then ``add_peer``, ``transfer_leader`` and
``merge`` over gRPC, and a snapshot larger than 256 KiB through
``SnapshotChunk``.  Fresh clusters take what perturbs one: a raft entry
over gRPC's 4 MiB receive limit (an SST blob of 200,000 keys), which
the reference's followers never apply (ROADMAP fault 13) and the port's
apply; and a transaction over a region another client split behind the
client's route cache, which the reference's 2PC fails (fault 14) and the
port's retries.  No case waits on a wall-clock threshold.
"""

from __future__ import annotations

import concurrent.futures as cf
import time

import numpy as np
import pytest

from tikv_tpu.server import wire as ref_wire
from tikv_tpu.testing.dag import DagSelect
from tikv_tpu.testing.fixture import encode_table_row, int_table

from tikv_tpu_torch.convert import dag_from_wire

PKGS = ("ref", "port")


def _server_api(pkg: str):
    if pkg == "ref":
        from tikv_tpu import server
        from tikv_tpu.raftstore.metapb import Store
    else:
        from tikv_tpu_torch import server
        from tikv_tpu_torch.raftstore.metapb import Store
    return server, Store


def _start(pkg: str, runner_for, n_stores: int = 3, replicate=True,
           **node_kw) -> dict:
    """One PD and ``n_stores`` servers of ``pkg`` on loopback, region 1
    replicated onto every store when ``replicate``."""
    server, Store = _server_api(pkg)
    pd_server = server.PdServer("127.0.0.1:0")
    if pkg == "ref":
        # the reference's PD moves leaders off a store its slow score
        # flags (writes over 0.1 s on a loaded host); a transfer in flight
        # refuses the next proposal, which its client does not retry.  The
        # port's PD has no scheduler: the cases compare the two without it
        pd_server.pd.scheduler.evict_slow_leaders = False
    pd_server.start()
    pd_addr = f"127.0.0.1:{pd_server.port}"
    servers = []
    for _ in range(n_stores):
        node = server.Node("127.0.0.1:0", server.RemotePdClient(pd_addr),
                           device_runner=runner_for(), **node_kw)
        srv = server.TikvServer(node)
        node.addr = f"127.0.0.1:{srv.port}"
        node.pd.put_store(Store(node.store_id, node.addr))
        srv.start()
        servers.append(srv)
    client = server.TxnClient(pd_addr)
    if replicate:
        for srv in servers[1:]:
            client.add_peer(1, srv.node.store_id)
    return {"pkg": pkg, "pd": pd_server, "servers": servers,
            "client": client, "pd_addr": pd_addr}


def _stop(side: dict) -> None:
    close = getattr(side["client"], "close", None)
    if callable(close):
        close()
    for srv in side["servers"]:
        srv.stop()
    side["pd"].stop()


def _ref_runner():
    import jax

    from tikv_tpu.device.runner import DeviceRunner
    from tikv_tpu.parallel import make_mesh
    return DeviceRunner(mesh=make_mesh(jax.devices()[:1]))


def _port_runner():
    from tikv_tpu_torch.device.runner import DeviceRunner
    return DeviceRunner(device="cpu")


@pytest.fixture(scope="module")
def pair():
    ref_runner = _ref_runner()      # shared, as test_server.py's
    sides = {"ref": _start("ref", lambda: ref_runner,
                           device_row_threshold=128),
             "port": _start("port", _port_runner, device_row_threshold=128)}
    try:
        yield sides
    finally:
        for side in sides.values():
            _stop(side)


def both(pair, fn):
    """``fn(side)`` on each cluster → (reference's, port's)."""
    return fn(pair["ref"]), fn(pair["port"])


def cop_dag(side, dag):
    """A DAG built with the reference's builder, as the side's client
    takes it (the port's through its own wire decoder)."""
    if side["pkg"] == "ref":
        return dag
    return dag_from_wire(ref_wire.enc_dag(dag))


def wait_until(cond, what: str, timeout: float = 30.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, what
        time.sleep(0.02)


def _engine_keys(engine, cf: str) -> list:
    out = []
    it = engine.iterator_cf(cf)
    ok = it.seek_to_first()
    while ok:
        out.append(it.key())
        ok = it.next()
    return out


# ------------------------------------------------------- test_server.py


def test_txn_put_get_over_network(pair):
    def run(side):
        c = side["client"]
        c.put(b"net-k", b"net-v")
        got = c.get(b"net-k")
        # replicated to all three stores' engines
        wait_until(lambda: all(
            _engine_keys(s.node.engine, "write")
            for s in side["servers"]), "a store lacks the write")
        return got, [len(_engine_keys(s.node.engine, "write")) > 0
                     for s in side["servers"]]
    ref, port = both(pair, run)
    assert port == ref == (b"net-v", [True, True, True])


def test_multi_key_2pc(pair):
    def run(side):
        c = side["client"]
        ts = c.txn_write([("put", b"2pc-a", b"1"), ("put", b"2pc-b", b"2"),
                          ("put", b"2pc-c", b"3")])
        return ts > 0, [c.get(k) for k in (b"2pc-a", b"2pc-b", b"2pc-c")]
    ref, port = both(pair, run)
    assert port == ref == (True, [b"1", b"2", b"3"])


def test_snapshot_read_versions(pair):
    def run(side):
        c = side["client"]
        c.put(b"ver-k", b"v1")
        ts1 = c.tso()
        c.put(b"ver-k", b"v2")
        return c.get(b"ver-k"), c.get(b"ver-k", version=ts1)
    ref, port = both(pair, run)
    assert port == ref == (b"v2", b"v1")


def test_scan_over_network(pair):
    def run(side):
        c = side["client"]
        for i in range(5):
            c.put(b"scan-%d" % i, b"%d" % i)
        return c.scan(b"scan-", b"scan-\xff", 10)
    ref, port = both(pair, run)
    assert port == ref == [(b"scan-%d" % i, b"%d" % i) for i in range(5)]


def test_lock_resolution_over_network(pair):
    """A reader resolves an abandoned (crashed-writer) lock by TTL."""
    def run(side):
        c = side["client"]
        c.put(b"lock-k", b"old")
        start_ts = c.tso()
        client, _ = c._leader_client(b"lock-k")
        client.call("KvPrewrite", {
            "mutations": [{"op": "put", "key": b"lock-k",
                           "value": b"orphan"}],
            "primary": b"lock-k", "start_version": start_ts,
            "lock_ttl": 1})
        time.sleep(0.01)
        return c.get(b"lock-k")
    ref, port = both(pair, run)
    assert port == ref == b"old"


def test_write_conflict_surfaces(pair):
    def run(side):
        c = side["client"]
        c.put(b"wc-k", b"v")
        client, _ = c._leader_client(b"wc-k")
        try:
            client.call("KvPrewrite", {
                "mutations": [{"op": "put", "key": b"wc-k", "value": b"x"}],
                "primary": b"wc-k", "start_version": 1})
        except Exception as e:      # noqa: BLE001 — the wire error
            err = dict(e.err)
            # the conflicting commit's timestamps are each cluster's own
            err.pop("conflict_start_ts")
            err.pop("conflict_commit_ts")
            return type(e).__name__, err
        return None
    ref, port = both(pair, run)
    assert port == ref
    assert ref[0] == "RemoteError" and ref[1]["kind"] == "write_conflict"


def test_raw_api_over_network(pair):
    def run(side):
        c = side["client"]
        c.raw_put(b"raw-k", b"raw-v")
        return c.raw_get(b"raw-k")
    ref, port = both(pair, run)
    assert port == ref == b"raw-v"


def test_coprocessor_over_network(pair):
    """A DAG request through the wire: the server executes over its MVCC
    snapshot on the host (50 rows, under the device threshold)."""
    table = int_table(2, table_id=9101)

    def run(side):
        c = side["client"]
        for h in range(50):
            c.put(*encode_table_row(table, h, {"c0": h % 5, "c1": h}))
        sel = DagSelect.from_table(table, ["id", "c0", "c1"])
        dag = sel.where(sel.col("c0").eq(2)).aggregate(
            [], [("count_star", None), ("sum", sel.col("c1"))]
        ).build(start_ts=c.tso())
        resp = c.coprocessor(cop_dag(side, dag))
        return resp["rows"], resp["backend"], \
            len(resp["exec_summaries"]) >= 2
    ref, port = both(pair, run)
    expect = [h for h in range(50) if h % 5 == 2]
    assert port == ref == ([[len(expect), sum(expect)]], "host", True)


def _group_by(table, ts):
    sel = DagSelect.from_table(table, ["id", "c0", "c1"])
    return sel.aggregate([sel.col("c0")], [("count_star", None),
                                           ("sum", sel.col("c1"))]).build(
        start_ts=ts)


def test_coprocessor_device_backend_over_network(pair):
    """A Coprocessor RPC against the raft cluster routes to the device
    backend through the region's columnar cache; a repeat hits the cache,
    and a write is seen by the next read."""
    table = int_table(2, table_id=9102)

    def run(side):
        c = side["client"]
        c.txn_write([("put",) + encode_table_row(table, h,
                                                 {"c0": h % 7, "c1": h})
                     for h in range(300)])
        first = c.coprocessor(cop_dag(side, _group_by(table, c.tso())))
        host = c.coprocessor(cop_dag(side, _group_by(table, c.tso())),
                             force_backend="host")
        hits = sum(s.node.copr_cache.hits for s in side["servers"])
        again = c.coprocessor(cop_dag(side, _group_by(table, c.tso())))
        hit = sum(s.node.copr_cache.hits for s in side["servers"]) > hits
        c.txn_write([("put",) + encode_table_row(table, 300,
                                                 {"c0": 0, "c1": 1000})])
        after = c.coprocessor(cop_dag(side, _group_by(table, c.tso())))
        return [(r["backend"], sorted(r["rows"]))
                for r in (first, host, again, after)], hit
    ref, port = both(pair, run)
    assert port == ref
    expect = sorted([sum(1 for h in range(300) if h % 7 == g),
                     sum(h for h in range(300) if h % 7 == g), g]
                    for g in range(7))
    assert ref[0][0] == ("device", expect) and ref[0][1][0] == "host"
    assert ref[1] is True


def test_concurrent_coprocessor_over_network(pair):
    """Six concurrent warm Coprocessor RPCs through the async serving
    path answer as the serial one does."""
    table = int_table(2, table_id=9103)

    def run(side):
        c = side["client"]
        c.txn_write([("put",) + encode_table_row(table, h,
                                                 {"c0": h % 5, "c1": h})
                     for h in range(400)])
        serial = c.coprocessor(cop_dag(side, _group_by(table, c.tso())))
        ts = c.tso()
        with cf.ThreadPoolExecutor(6) as ex:
            futs = [ex.submit(c.coprocessor,
                              cop_dag(side, _group_by(table, ts)))
                    for _ in range(6)]
            resps = [f.result(timeout=120) for f in futs]
        return serial["backend"], sorted(serial["rows"]), \
            [(r["backend"], sorted(r["rows"]), "time_detail" in r)
             for r in resps]
    ref, port = both(pair, run)
    assert port == ref
    assert ref[0] == "device"
    assert all(r == ("device", ref[1], True) for r in ref[2])


def test_split_and_routing_over_network(pair):
    def run(side):
        c = side["client"]
        c.put(b"srv-a", b"1")
        c.put(b"srv-z", b"2")
        c.split(b"srv-m")

        def apart():
            from tikv_tpu_torch.storage.txn_types import encode_key
            try:
                return c.pd.get_region(encode_key(b"srv-a")).id != \
                    c.pd.get_region(encode_key(b"srv-z")).id
            except Exception:   # noqa: BLE001 — transient routing gap
                return False
        wait_until(apart, "the split never reached PD")
        c.put(b"srv-zz", b"3")
        return c.get(b"srv-a"), c.get(b"srv-z"), c.get(b"srv-zz")
    ref, port = both(pair, run)
    assert port == ref == (b"1", b"2", b"3")


def test_lease_reads_and_read_pool_over_network(pair):
    """Repeated gets ride the leader lease (no log barrier a read) and
    flow through the read pool."""
    def run(side):
        c = side["client"]
        c.put(b"lease-k", b"lv")
        servers = side["servers"]
        # heartbeat acks establish the lease: wait for the first lease
        # read instead of sleeping
        wait_until(lambda: c.get(b"lease-k") == b"lv" and sum(
            s.node.raft_kv.lease_reads for s in servers) > 0,
            "no lease read")
        # ten gets, at least eight of them lease reads: a lease that
        # lapsed under a loaded host is renewed by the next heartbeat,
        # so a round of ten is tried again (five rounds at most)
        for _ in range(5):
            before = sum(s.node.raft_kv.lease_reads for s in servers)
            got = [c.get(b"lease-k") for _ in range(10)]
            gain = sum(s.node.raft_kv.lease_reads for s in servers) - before
            if gain >= 8:
                break
        return got, gain >= 8, \
            sum(s.node.read_pool.served for s in servers) > 0
    ref, port = both(pair, run)
    assert port == ref == ([b"lv"] * 10, True, True)


def test_store_status(pair):
    def run(side):
        srv = side["servers"][0]
        st = side["client"].status(srv.node.store_id)
        return st["store_id"] == srv.node.store_id, bool(st["regions"]), \
            sorted(st["regions"][0])
    ref, port = both(pair, run)
    assert port[:2] == ref[:2] == (True, True)
    # each region's entry carries the reference's fields, resolved_ts
    # among them
    assert port[2] == ref[2]


def test_region_meta_consistent_across_stores(pair):
    """Peers added through snapshots learn the full region metadata:
    every store's view of every region is the same, with three peers."""
    def run(side):
        c = side["client"]
        c.put(b"meta-k", b"v")
        c.split(b"meta-m")

        def views():
            out = {}
            for srv in side["servers"]:
                for r in srv.node.status()["regions"]:
                    reg = r["region"]
                    out.setdefault(reg["id"], set()).add((
                        tuple(sorted((p["id"], p["store_id"])
                                     for p in reg["peers"])),
                        reg["conf_ver"], reg["version"]))
            return out

        def settled():
            v = views()
            return all(len(s) == 1 and len(next(iter(s))[0]) == 3
                       for s in v.values()) and \
                all(len(srv.node.status()["regions"]) == len(v)
                    for srv in side["servers"])
        wait_until(settled, "a store's region view diverged")
        v = views()
        return sorted((len(next(iter(s))[0]), next(iter(s))[1:])
                      for s in v.values())
    ref, port = both(pair, run)
    assert port == ref


# ------------------------------------------------ membership and moves


def _region_of(side, key: bytes):
    from tikv_tpu_torch.storage.txn_types import encode_key
    return side["client"].pd.get_region_with_leader(encode_key(key))


def _region_id_at(side, key: bytes):
    """The id of the region PD routes ``key`` to; None in a split's
    routing gap (PD has the shrunk parent, not yet the child)."""
    try:
        return _region_of(side, key)[0].id
    except Exception:   # noqa: BLE001 — the gap
        return None


def test_add_peer_transfer_leader_merge_over_grpc(pair):
    """A fresh region split off, one of its peers removed and added back
    (``ChangePeer`` over gRPC: the new peer catches up), its leader moved
    to another store through ``TransferLeader`` and back, then merged into
    its neighbour (``MergeRegion``: every source peer's apply index polled
    over ``RegionApplied``)."""
    def run(side):
        c = side["client"]
        servers = side["servers"]
        for i in range(20):
            c.put(b"mv-%02d" % i, b"%d" % i)
        right = c.split(b"mv-10")
        rid = right.id
        wait_until(lambda: _region_id_at(side, b"mv-15") == rid and all(
            rid in s.node.raft_store.peers for s in servers),
            "the split child is not on every store")
        # remove store 3's peer (a follower: store 1 leads), then add a
        # new one back
        lead_on(side, rid, servers[0])
        victim = next(p for p in c.pd.get_region_by_id(rid).peers
                      if p.store_id == servers[2].node.store_id)
        c.remove_peer(rid, victim)
        wait_until(lambda: rid not in servers[2].node.raft_store.peers,
                   "the removed peer lives")
        # the client routes the add by PD's view of the region
        wait_until(lambda: victim not in c.pd.get_region_by_id(rid).peers,
                   "PD still lists the removed peer")
        added = c.add_peer(rid, servers[2].node.store_id)
        wait_until(lambda: rid in servers[2].node.raft_store.peers and
                   servers[2].node.raft_store.peers[rid].node.applied >=
                   servers[0].node.raft_store.peers[rid].node.applied,
                   "the added peer did not catch up")
        # the leader to store 2 and back
        moves = []
        for target in (servers[1], servers[0]):
            lead_on(side, rid, target)
            moves.append(c.get(b"mv-15"))
        # merge the right child back into its left neighbour
        wait_until(lambda: _region_id_at(side, b"mv-05") is not None,
                   "no route to the left neighbour")
        left_id = _region_id_at(side, b"mv-05")
        for r in (rid, left_id):
            lead_on(side, r, servers[0])
        merged = c.merge(rid, left_id)
        wait_until(lambda: all(rid not in s.node.raft_store.peers
                               for s in servers), "the source lives")
        return (added.store_id == servers[2].node.store_id, moves,
                merged.id == left_id,
                [c.get(b"mv-%02d" % i) for i in (0, 10, 19)])
    ref, port = both(pair, run)
    assert port == ref == (True, [b"15", b"15"], True, [b"0", b"10", b"19"])


def lead_on(side, rid: int, target) -> None:
    """Move the leader of ``rid`` to the server ``target`` (a
    ``TransferLeader`` RPC) unless it leads already; wait until it alone
    leads."""
    c, servers = side["client"], side["servers"]
    if leader_of_region(servers, rid) == target.node.store_id:
        return
    region = c.pd.get_region_by_id(rid)
    to = next(p for p in region.peers
              if p.store_id == target.node.store_id)
    c._call_leader_by_region(region, "TransferLeader", {
        "region_id": rid, "to_peer_id": to.id})
    wait_until(lambda: leader_of_region(servers, rid) ==
               target.node.store_id, "the leader did not move")


def leader_of_region(servers, rid):
    """The store whose peer leads ``rid``, once no other store's peer
    believes it leads (a transfer's old leader refuses proposals until it
    steps down); None meanwhile."""
    leads = [s.node.store_id for s in servers
             if rid in s.node.raft_store.peers and
             s.node.raft_store.peers[rid].is_leader()]
    return leads[0] if len(leads) == 1 else None


def test_snapshot_over_256_kib_through_snapshot_chunk(pair):
    """A peer added to a region of about 600 KiB catches up by a raft
    snapshot whose payload rides ``SnapshotChunk`` calls; the new store's
    CFs for the region equal the leader's."""
    def run(side):
        c = side["client"]
        servers = side["servers"]
        rid = c.split(b"snap-").id
        wait_until(lambda: all(rid in s.node.raft_store.peers
                               for s in servers), "no child everywhere")
        rng = np.random.default_rng(28)
        vals = [rng.bytes(600) for _ in range(1000)]
        c.txn_write([("put", b"snap-%04d" % i, v)
                     for i, v in enumerate(vals)])
        lead_on(side, rid, servers[0])
        victim = next(p for p in c.pd.get_region_by_id(rid).peers
                      if p.store_id == servers[2].node.store_id)
        c.remove_peer(rid, victim)
        wait_until(lambda: rid not in servers[2].node.raft_store.peers,
                   "the removed peer lives")
        # the client routes the add by PD's view of the region
        wait_until(lambda: victim not in c.pd.get_region_by_id(rid).peers,
                   "PD still lists the removed peer")
        chunks0 = sum(getattr(s.service, "snap_chunks", 0)
                      for s in servers)
        c.add_peer(rid, servers[2].node.store_id)
        lead = servers[0].node.raft_store.peers[rid]
        wait_until(lambda: rid in servers[2].node.raft_store.peers and
                   servers[2].node.raft_store.peers[rid].node.applied >=
                   lead.node.applied, "no snapshot catch-up", 60)
        from tikv_tpu_torch.raftstore.peer_storage import region_data_bounds
        lo, hi = region_data_bounds(lead.region)
        same = all(
            servers[0].node.engine.range_cf(cf, lo, hi)[:2] ==
            servers[2].node.engine.range_cf(cf, lo, hi)[:2]
            for cf in ("default", "lock", "write"))
        chunks = sum(getattr(s.service, "snap_chunks", 0)
                     for s in servers) - chunks0
        return same, [c.get(b"snap-%04d" % i) for i in (0, 999)] == \
            [vals[0], vals[999]], chunks
    ref, port = both(pair, run)
    assert port[:2] == ref[:2] == (True, True)
    # 600 KB of values: at least three chunks of 256 KiB
    assert port[2] >= 3, port[2]


# --------------------------------------------------- fresh clusters


def _blob(pkg: str, n: int) -> bytes:
    if pkg == "ref":
        from tikv_tpu.sst_importer import fast_mvcc_table_sst
    else:
        from tikv_tpu_torch.sst_importer import fast_mvcc_table_sst
    h = np.arange(n, dtype=np.int64)
    return fast_mvcc_table_sst(7001, h, [(2, h % 1024, None),
                                         (3, h % 1000, None)], 100)


def _ingest_over_limit(pkg: str, runner_for) -> tuple:
    side = _start(pkg, runner_for)
    try:
        blob = _blob(pkg, 200_000)
        assert len(blob) > 4 << 20
        try:
            n = side["client"].ingest_sst(blob, b"")
            err = None
        except Exception as e:      # noqa: BLE001 — the pinned failure
            n, err = None, getattr(e, "kind", type(e).__name__)
        if err is None:
            lead = side["servers"][0].node.raft_store.peers[1]
            wait_until(lambda: all(
                s.node.raft_store.peers[1].node.applied >= lead.node.applied
                for s in side["servers"]), "a follower lags", 60)
        rows = [len(s.node.engine.range_cf("write", b"", b"\xff")[0])
                for s in side["servers"]]
        return n, err, rows
    finally:
        _stop(side)


def test_ingest_over_grpc_receive_limit():
    """One SST v2 blob of 200,000 keys (about 10 MiB, one raft entry)
    ingested into a three-store cluster: the reference's BatchRaft call
    carrying the entry is refused at the followers' servers (gRPC's 4 MiB
    receive limit) with the heartbeats batched beside it, leadership
    churns, the ingest fails and no store applies it — fault 13, pinned; the port's channels and servers take messages up to 2 GiB, and
    all three stores hold the 200,000 rows."""
    ref = _ingest_over_limit("ref", lambda: None)
    port = _ingest_over_limit("port", _port_runner)
    # the error's kind depends on the churn: not_leader, or the proposal's
    # "raft command stalled"
    assert ref[0] is None and ref[1] in ("not_leader", "other") and \
        ref[2] == [0, 0, 0], ref
    assert port == (200_000, None, [200_000] * 3)


def _txn_across_foreign_split(pkg: str, runner_for) -> tuple:
    side = _start(pkg, runner_for, n_stores=1, replicate=False)
    server, _ = _server_api(pkg)
    other = server.TxnClient(side["pd_addr"])
    try:
        c = side["client"]
        c.put(b"fs-a", b"0")        # caches region 1's whole range
        other.split(b"fs-m")
        wait_until(lambda: _region_id_at(side, b"fs-z") not in (None, 1),
                   "the split never reached PD")
        try:
            c.txn_write([("put", b"fs-a", b"1"), ("put", b"fs-z", b"2")])
            err = None
        except Exception as e:      # noqa: BLE001 — the pinned failure
            err = "KeyNotInRegion" in str(e)
        return err, c.get(b"fs-a"), c.get(b"fs-z")
    finally:
        close = getattr(other, "close", None)
        if callable(close):
            close()
        _stop(side)


def test_txn_write_across_a_split_behind_the_route_cache():
    """Another client splits the region after this client cached its
    bounds: the reference's 2PC sends the prewrite to the shrunk region,
    gets ``KeyNotInRegion`` and fails (fault 14, pinned: its leader retry
    re-routes on that error, its 2PC does not); the port's re-routes and
    commits both keys."""
    ref = _txn_across_foreign_split("ref", lambda: None)
    port = _txn_across_foreign_split("port", _port_runner)
    assert ref == (True, b"0", None), ref
    assert port == (None, b"1", b"2"), port


# ------------------------------------------------------- the pieces


def test_backoff_schedule_matches_reference():
    """The same seeded jitter gives the same delays in both packages,
    capped and with a server's hint in place of the exponential step."""
    import random

    from tikv_tpu.utils.backoff import Backoff as RefBackoff

    from tikv_tpu_torch.utils.backoff import Backoff

    def schedule(cls):
        bo = cls(base=0.02, cap=0.5, rng=random.Random(28),
                 jitter=(0.8, 1.0))
        out = []
        for attempt in range(8):
            bo.attempt = attempt
            out.append(bo.next_delay())
        return out, bo.rpc_timeout(10.0)
    assert schedule(Backoff) == schedule(RefBackoff)


@pytest.mark.parametrize("events", ["fff", "ffs", "fffsf", "sfff", "ff"])
def test_circuit_breaker_matches_reference(events):
    """Failures trip the breaker at the threshold, it refuses sends while
    open, admits one probe once the cooldown has passed, and a success
    closes it: the same states as the reference's."""
    from tikv_tpu.utils.health import CircuitBreaker as RefBreaker

    from tikv_tpu_torch.utils.health import CircuitBreaker

    def run(cls):
        br = cls(threshold=3, cooldown_s=0.0)
        out = []
        for e in events:
            br.record_failure() if e == "f" else br.record_success()
            out.append((br.state(), br.stats()["trips"]))
        out.append((br.allow(), br.allow()))
        return out
    assert run(CircuitBreaker) == run(RefBreaker)


def test_transport_batches_stop_at_their_byte_budget():
    """A store's queue leaves in batches of at most ``MAX_BATCH`` messages
    and, past the first, ``BATCH_BYTES`` of payload: an entry larger than
    the budget goes alone, never held back."""
    from tikv_tpu_torch.server.node import _StoreConn
    conn = _StoreConn(7)
    sizes = [10, 70 << 20, 5, 30 << 20, 40 << 20, 1]
    for i, n in enumerate(sizes):
        assert conn.push({"i": i}, n)
    budget = 64 << 20
    batches = []
    while conn.queue:
        msgs, expired = conn.pop_batch(time.monotonic(), budget)
        assert expired == 0
        batches.append([m["i"] for m in msgs])
    assert batches == [[0], [1], [2, 3], [4, 5]]
    assert conn.breaker_state() == "closed"
    conn.on_failure(time.monotonic())
    assert conn.breaker_state() == "open" and conn.fail_count == 1
