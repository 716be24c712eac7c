"""The port's stale reads under resolved-ts (``tikv_tpu_torch.cdc``
``Resolver`` / ``ResolvedTsObserver``, ``RaftPeer.stale_snapshot``, the
node's advance and ``CheckLeader`` fan-out, the follower's coprocessor
leg and the client's hedged and replica reads) against the JAX package's.

The resolved-ts units first: ``Resolver`` and ``ResolvedTsObserver`` of
both packages take the same seeded lock and apply sequences and publish
equal watermarks.  Then one networked cluster of each package (one PD,
three stores on loopback, region 1 replicated onto every store, as
``test_torch_grpc.py`` builds them; the port's nodes each with a
``DeviceRunner(device="cpu")``, ``device_row_threshold=128``) takes the
same requests: follower stale reads against the leader's answer and the
reference's over a NULL-heavy and a tombstoned table, a write the
follower's feed takes as a patch, the refusals (``DataIsNotReady`` with
the reference's fields, the ``device::replica_stale`` failpoint) and the
hedge's fall-through to the leader, ``CheckLeader`` against a lagging
apply, a hedged get answered by the follower while the leader is slowed
(the port: the ``read::before_leader_read`` failpoint's ``sleep``; the
reference: its store's ``slow_down``), and a leader change onto the
replica feed, promoted with no rebuild.  No case compares latencies.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from tikv_tpu.server import wire as ref_wire
from tikv_tpu.testing.dag import DagSelect
from tikv_tpu.testing.fixture import encode_table_row, int_table, \
    table_record_key
from tikv_tpu.utils import failpoint as ref_failpoint

from tikv_tpu_torch.convert import dag_from_wire
from tikv_tpu_torch.utils import failpoint

PKGS = ("ref", "port")

# ------------------------------------------------------------ resolvers


def _resolved_ts_api(pkg: str):
    if pkg == "ref":
        from tikv_tpu.cdc import resolved_ts as rts
        from tikv_tpu.raftstore.cmd import WriteOp
        from tikv_tpu.storage import txn_types as tt
    else:
        from tikv_tpu_torch.cdc import resolved_ts as rts
        from tikv_tpu_torch.raftstore.cmd import WriteOp
        from tikv_tpu_torch.storage import txn_types as tt
    return rts, WriteOp, tt


@pytest.mark.parametrize("seed", range(4))
def test_resolver_matches_reference(seed):
    rng = np.random.default_rng(seed)
    res = {p: _resolved_ts_api(p)[0].Resolver(1) for p in PKGS}
    for _ in range(300):
        op = rng.integers(3)
        key = b"k%d" % rng.integers(20)
        ts = int(rng.integers(1, 10_000))
        for r in res.values():
            if op == 0:
                r.track_lock(key, ts)
            elif op == 1:
                r.untrack_lock(key)
        got = {p: (r.advance(ts) if op == 2 else r.resolved_ts,
                   r.min_lock_ts()) for p, r in res.items()}
        assert got["port"] == got["ref"]


@pytest.mark.parametrize("seed", range(4))
def test_observer_matches_reference(seed):
    """The same applied entries — CF_LOCK puts and deletes (commits and
    rollbacks), CF_WRITE and CF_DEFAULT noise, a key outside the txn
    keyspace — over three regions, advanced for the leader regions: equal
    watermarks at every step."""
    rng = np.random.default_rng(seed)
    obs, api = {}, {}
    for p in PKGS:
        rts, WriteOp, tt = _resolved_ts_api(p)
        obs[p], api[p] = rts.ResolvedTsObserver(), (WriteOp, tt)
    for step in range(200):
        rid = int(rng.integers(1, 4))
        key = b"t%03d" % rng.integers(30)
        start_ts = int(rng.integers(1, 50_000))
        kind = int(rng.integers(5))
        for p in PKGS:
            WriteOp, tt = api[p]
            ek = tt.encode_key(key)
            if kind == 0:
                lock = tt.Lock(tt.LockType.PUT, b"t000", start_ts, 3000)
                ops = (WriteOp("put", "lock", ek, lock.to_bytes()),)
            elif kind == 1:
                ops = (WriteOp("delete", "lock", ek),)
            elif kind == 2:
                ops = (WriteOp("put", "write", tt.append_ts(ek, start_ts),
                               b"P"), WriteOp("put", "default", ek, b"v"))
            elif kind == 3:
                ops = (WriteOp("put", "lock", b"\x01raw", b"junk"),)
            else:
                ops = ()
            obs[p].on_apply_write(rid, step, ops)
        ts = int(rng.integers(1, 60_000))
        leaders = [r for r in (1, 2, 3) if rng.random() < 0.7]
        got = {p: obs[p].advance_all(ts, leaders) for p in PKGS}
        assert got["port"] == got["ref"]
        assert {r: obs["port"].resolver(r).resolved_ts for r in (1, 2, 3)} \
            == {r: obs["ref"].resolver(r).resolved_ts for r in (1, 2, 3)}


# ------------------------------------------------------------- clusters


def _server_api(pkg: str):
    if pkg == "ref":
        from tikv_tpu import server
        from tikv_tpu.raftstore.metapb import Store
    else:
        from tikv_tpu_torch import server
        from tikv_tpu_torch.raftstore.metapb import Store
    return server, Store


def _start(pkg: str, runner_for) -> dict:
    server, Store = _server_api(pkg)
    pd_server = server.PdServer("127.0.0.1:0")
    if pkg == "ref":
        # its PD moves leaders off a store its slow score flags; the
        # cases here move leaders themselves
        pd_server.pd.scheduler.evict_slow_leaders = False
    pd_server.start()
    pd_addr = f"127.0.0.1:{pd_server.port}"
    servers = []
    for _ in range(3):
        node = server.Node("127.0.0.1:0", server.RemotePdClient(pd_addr),
                           device_runner=runner_for(),
                           device_row_threshold=128)
        srv = server.TikvServer(node)
        node.addr = f"127.0.0.1:{srv.port}"
        node.pd.put_store(Store(node.store_id, node.addr))
        srv.start()
        servers.append(srv)
    client = server.TxnClient(pd_addr)
    for srv in servers[1:]:
        client.add_peer(1, srv.node.store_id)
    return {"pkg": pkg, "pd": pd_server, "servers": servers,
            "client": client, "pd_addr": pd_addr, "server": server}


@pytest.fixture(scope="module")
def pair():
    import jax

    from tikv_tpu.device.runner import DeviceRunner as RefRunner
    from tikv_tpu.parallel import make_mesh
    from tikv_tpu_torch.device.runner import DeviceRunner
    ref_runner = RefRunner(mesh=make_mesh(jax.devices()[:1]))
    sides = {"ref": _start("ref", lambda: ref_runner),
             "port": _start("port", lambda: DeviceRunner(device="cpu"))}
    try:
        for side in sides.values():
            wait_until(lambda: all(
                s.node.raft_store.peers.get(1) is not None
                for s in side["servers"]), "region 1 on every store")
        yield sides
    finally:
        for side in sides.values():
            side["client"].close()
            for srv in side["servers"]:
                srv.stop()
            side["pd"].stop()


@pytest.fixture(autouse=True)
def _disarm():
    yield
    failpoint.teardown()
    ref_failpoint.teardown()


def wait_until(cond, what: str, timeout: float = 30.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, what
        time.sleep(0.02)


def dag_for(side, dag):
    return dag if side["pkg"] == "ref" else \
        dag_from_wire(ref_wire.enc_dag(dag))


def leaders(side) -> list:
    return [srv for srv in side["servers"]
            if srv.node.raft_store.peers.get(1) is not None and
            srv.node.raft_store.peers[1].is_leader()]


def leader(side):
    lead = leaders(side)
    assert lead, "no leader of region 1"
    return lead[0]


def followers(side):
    lead = leader(side)
    return [s for s in side["servers"] if s is not lead]


def load(side, table, rows, dels=()):
    muts = [("put",) + encode_table_row(table, h, row) for h, row in rows]
    muts += [("delete", table_record_key(table.table_id, h), None)
             for h in dels]
    side["client"].txn_write(muts)


def _sel(table, thr, ts):
    s = DagSelect.from_table(table, [c.name for c in table.columns])
    return s.where(s.col("c1") > thr).build(start_ts=ts)


def _agg(table, ts):
    s = DagSelect.from_table(table, ["id", "c0", "c1"])
    return s.aggregate([s.col("c0")], [("count_star", None),
                                       ("sum", s.col("c1"))]).build(ts)


def stale_call(side, dag, store_id) -> dict:
    """One follower stale read: the port's ``coprocessor_replica`` to the
    store named; the reference's client names no store, so its request
    goes to the store directly, as its own tests send it."""
    if side["pkg"] == "port":
        return side["client"].coprocessor_replica(
            dag_for(side, dag), timeout=60, store_id=store_id)
    return side["client"]._store_call(store_id, "Coprocessor", {
        "tp": 103, "dag": ref_wire.enc_dag(dag), "force_backend": None,
        "paging_size": 0, "resume_token": None,
        "resource_group": "default", "request_source": "",
        "stale_read": True}, 60)


def replica_ask(side, dag, store_id, deadline: float = 15.0) -> dict:
    """A follower's stale read, retried while its watermark (pushed on
    the leader's heartbeat cadence) has not reached the snapshot ts."""
    end = time.monotonic() + deadline
    while True:
        try:
            return stale_call(side, dag, store_id)
        except side["server"].RemoteError as e:
            if e.kind != "data_is_not_ready" or time.monotonic() > end:
                raise
            time.sleep(0.02)


def both_ts(pair) -> int:
    """One timestamp both clusters' clocks have passed."""
    return max(pair[p]["client"].tso() for p in PKGS)


@pytest.mark.parametrize("shape", ["null_heavy", "tombstoned"])
def test_follower_reads_match_the_leader_and_reference(pair, shape):
    """Each follower's stale read over its own feed answers the leader's
    rows and the reference's follower's; a write lands in the follower's
    feed as a patch (the port's follower labels the read ``delta``), and
    the next stale read holds it."""
    table = int_table(2, table_id=9901 + (shape == "tombstoned"))
    rng = np.random.default_rng(42)
    rows, dels = [], ()
    for h in range(1200):
        row = {}
        if shape == "tombstoned" or rng.random() > 0.5:
            row["c0"] = int(rng.integers(-50, 50))
        if shape == "tombstoned" or rng.random() > 0.2:
            row["c1"] = int(rng.integers(-1000, 1000))
        rows.append((h, row))
    for side in pair.values():
        load(side, table, rows)
        if shape == "tombstoned":
            load(side, table, [], dels=range(0, 1200, 3))
    ts = both_ts(pair)
    got = {}
    for p, side in pair.items():
        lead = side["client"].coprocessor(dag_for(side, _sel(table, 0, ts)),
                                          timeout=60)
        assert lead["backend"] == "device"
        for f in followers(side):
            r = replica_ask(side, _sel(table, 0, ts), f.node.store_id)
            assert r["rows"] == lead["rows"], (p, f.node.store_id)
            assert r["backend"] == "device"
        got[p] = lead["rows"]
    assert got["port"] == got["ref"] and got["port"]
    # a write: the followers' feeds take it as a patch
    for side in pair.values():
        load(side, table, [(10_000 + i, {"c0": 1, "c1": 999})
                           for i in range(40)])
    ts = both_ts(pair)
    after = {}
    for p, side in pair.items():
        for f in followers(side):
            if p == "port":
                routes0 = dict(f.node.device_runner.feed_routes)
            r = replica_ask(side, _sel(table, 0, ts), f.node.store_id)
            assert len(r["rows"]) == len(got[p]) + 40
            if p == "port":
                assert r["time_detail"]["labels"]["copr_cache"] == "delta"
                routes = f.node.device_runner.feed_routes
                assert {k: v - routes0.get(k, 0) for k, v in routes.items()
                        if v != routes0.get(k, 0)} == {"patch": 1}
            after[p] = r["rows"]
    assert after["port"] == after["ref"]
    port = pair["port"]
    for f in followers(port):
        st = f.node.replica_serving_stats()
        assert 1 in st["replica_regions"] and st["replica_reads"] >= 2


def test_lagging_replica_refuses_with_the_reference_fields(pair):
    """Above the follower's watermark: ``DataIsNotReady`` carrying the
    reference's fields; the ``device::replica_stale`` failpoint forces
    the same refusal below it; a hedged read whose follower refuses falls
    through to the leader's answer."""
    from tikv_tpu_torch.storage.txn_types import compose_ts
    table = int_table(2, table_id=9903)
    for side in pair.values():
        load(side, table, [(h, {"c0": h % 5, "c1": h % 50})
                           for h in range(400)])
    future = compose_ts(int(time.time() * 1000) + 3_600_000, 0)
    errs = {}
    for p, side in pair.items():
        f = followers(side)[0].node.store_id
        with pytest.raises(side["server"].RemoteError) as ei:
            stale_call(side, _sel(table, 5, future), f)
        errs[p] = ei.value.err
    assert set(errs["port"]) == set(errs["ref"])
    for k in ("kind", "region_id", "read_ts", "code"):
        assert errs["port"][k] == errs["ref"][k], k
    assert errs["port"]["kind"] == "data_is_not_ready"
    assert 0 < errs["port"]["safe_ts"] < future
    # the failpoint: the refusal below the watermark, safe_ts 0
    ts = both_ts(pair)
    base = {}
    for p, side in pair.items():
        f = followers(side)[0].node.store_id
        base[p] = replica_ask(side, _sel(table, 5, ts), f)["rows"]
        (failpoint if p == "port" else ref_failpoint).cfg(
            "device::replica_stale", "1*return")
        with pytest.raises(side["server"].RemoteError) as ei:
            stale_call(side, _sel(table, 5, ts), f)
        assert ei.value.err["safe_ts"] == 0
        assert ei.value.err["kind"] == "data_is_not_ready"
    assert base["port"] == base["ref"]
    # the hedge: the leader slowed, the follower refusing → the leader's
    # answer
    port = pair["port"]
    refused0 = sum(s.node.replica_serving_stats()["refused"]
                   for s in port["servers"])
    hc = port["server"].TxnClient(port["pd_addr"], hedge_reads=True)
    try:
        failpoint.cfg("device::replica_stale", "return")
        failpoint.cfg("read::before_leader_read", "1*sleep(300)")
        r = hc.coprocessor(dag_for(port, _sel(table, 5, ts)), timeout=60)
    finally:
        failpoint.teardown()
        hc.close()
    assert r["rows"] == base["port"]
    assert hc.hedges.get("copr_fired") == 1
    assert hc.hedges.get("copr_stale_refused") == 1
    assert hc.hedges.get("copr_leader_won") == 1 and hc.hedges_won == 0
    assert sum(s.node.replica_serving_stats()["refused"]
               for s in port["servers"]) == refused0 + 1


def test_check_leader_waits_for_the_followers_apply(pair):
    """A follower takes the leader's watermark only once its own apply has
    reached the leader's applied index: a push ahead of its apply leaves
    the region out of ``advanced``; a push at its apply advances it (the
    answer's keys are strings, as the reference's)."""
    got = {}
    for p, side in pair.items():
        f = followers(side)[0]
        applied = f.node.raft_store.peers[1].applied_engine
        before = f.node.resolved_ts.resolver(1).resolved_ts
        c = side["server"].StoreClient(f.node.addr)
        try:
            ahead = c.call("CheckLeader", {"regions": [
                {"region_id": 1, "resolved_ts": before + 10 ** 9,
                 "applied_index": applied + 10 ** 6}]})
            at = c.call("CheckLeader", {"regions": [
                {"region_id": 1, "resolved_ts": 1,
                 "applied_index": applied}]})
        finally:
            c._chan.close()     # the reference's stub has no close()
        assert ahead["advanced"] == {}
        assert f.node.resolved_ts.resolver(1).resolved_ts < before + 10 ** 9
        assert list(at["advanced"]) == ["1"]
        assert at["advanced"]["1"] >= before > 0
        got[p] = (ahead, sorted(at["advanced"]))
    assert got["port"] == got["ref"]


def test_status_reports_resolved_ts(pair):
    """``Status`` lists each region's resolved_ts on every store, as the
    reference's does; the followers' have been pushed past 0."""
    for side in pair.values():
        for srv in side["servers"]:
            st = side["client"].status(srv.node.store_id)
            r1 = next(r for r in st["regions"] if r["region"]["id"] == 1)
            assert r1["resolved_ts"] > 0
    from tikv_tpu_torch.server.status_server import health
    body = health(followers(pair["port"])[0].node)
    assert 1 in body["replica_serving"]["replica_regions"]


def test_hedged_get_answers_from_the_follower(pair):
    """A hedged point get while the leader is slowed: the follower's leg
    (a stale read, else a ReadIndex replica read) answers, in both
    packages, with the value the leader would give."""
    values = {}
    for p, side in pair.items():
        side["client"].put(b"hedge-k", b"hedge-v")
        # a version the followers' watermarks have passed: their leg is
        # one stale read, whatever the host's load
        ts = side["client"].tso()
        wait_until(lambda: all(
            f.node.resolved_ts.resolver(1).resolved_ts >= ts
            for f in followers(side)), "the followers' watermarks")
        hc = side["server"].TxnClient(side["pd_addr"], hedge_reads=True)
        lead = leader(side)
        try:
            if p == "port":
                failpoint.cfg("read::before_leader_read", "1*sleep(1000)")
            else:
                lead.node.raft_store.slow_down(1.0)
            values[p] = hc.get(b"hedge-k", version=ts)
        finally:
            if p == "ref":
                lead.node.raft_store.slow_down(0.0)
            failpoint.teardown()
            hc.close()
        assert hc.hedges_fired == 1 and hc.hedges_won == 1, p
        if p == "port":
            assert hc.hedges == {"fired": 1, "follower_won": 1}
    assert values["port"] == values["ref"] == b"hedge-v"


def test_leader_change_promotes_the_replica_feed(pair):
    """A leader transfer onto a store whose follower read minted a replica
    feed promotes it by digest: ``promotion_rebuilds`` stays 0, and the
    new leader's first read builds nothing and uploads nothing — writes
    landing meanwhile are in it, as in the reference's."""
    table = int_table(2, table_id=9904)
    rows = [(h, {"c0": h % 11, "c1": (h * 13) % 500 - 250})
            for h in range(1500)]
    answers = {}
    for p, side in pair.items():
        load(side, table, rows)
        old = leader(side)
        target = followers(side)[0]
        ts = side["client"].tso()
        expect = side["client"].coprocessor(
            dag_for(side, _agg(table, ts)), timeout=60)
        got = replica_ask(side, _agg(table, ts), target.node.store_id)
        assert sorted(got["rows"]) == sorted(expect["rows"])
        sup = target.node.device_supervisor
        promos0, builds0 = sup.promotions, \
            target.node.copr_cache.stats()["misses"]
        routes0 = dict(target.node.device_runner.feed_routes) \
            if p == "port" else None
        load(side, table, [(20_000 + i, {"c0": 1, "c1": 400})
                           for i in range(50)])
        peer = next(pp for pp in old.node.raft_store.peers[1].region.peers
                    if pp.store_id == target.node.store_id)
        old.node.transfer_leader(1, peer.id)
        # the old leader refuses proposals until it steps down: the
        # transfer has landed once the target is the one leader
        wait_until(lambda: leaders(side) == [target],
                   "the transfer did not land")
        side["client"]._invalidate_region(b"")
        r = None
        t0 = time.monotonic()
        while r is None:
            try:
                r = side["client"].coprocessor(
                    dag_for(side, _agg(table, side["client"].tso())),
                    timeout=60)
            except Exception:   # noqa: BLE001 — a stale route: re-resolve
                assert time.monotonic() - t0 < 20
                side["client"]._invalidate_region(b"")
                time.sleep(0.05)
        answers[p] = sorted(r["rows"])
        assert sum(row[0] for row in r["rows"]) == 1550
        assert sup.promotions > promos0 and sup.promotion_rebuilds == 0
        assert target.node.copr_cache.stats()["misses"] == builds0, p
        if p == "port":
            routes = target.node.device_runner.feed_routes
            assert routes.get("upload", 0) == routes0.get("upload", 0)
            assert routes.get("device_resolve", 0) == \
                routes0.get("device_resolve", 0)
            assert sup.last_promotion["planes"] > 0
            assert target.node.replica_serving_stats()["promotions"] == \
                sup.promotions
    assert answers["port"] == answers["ref"]
