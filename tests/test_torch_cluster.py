"""The port's in-process multi-store cluster (``testing/cluster.py`` over
the port's raftstore) against the JAX package's.

``tests/test_raftstore.py``'s cases run against both packages: its source
is compiled a second time with the package name swapped, and every case
runs once per package (replication, failover, restart, split, PD routing,
add peer by snapshot, remove peer, partition and heal, log compaction with
snapshot catch-up, lease reads across a leader transfer, follower reads by
read index, transactions over the cluster).  Seeded scenarios then drive
both packages' ``Cluster`` with the same commands and require, after each
step, the same CFs on every store byte for byte (the raft CF included),
the same regions (id, range, epoch, peers), the same leaders, the same
applied and data indexes, and the same ``compute_hash`` digests.
"""

from __future__ import annotations

import importlib
import inspect
import pathlib
import random
import types

import pytest

PKGS = ("tikv_tpu", "tikv_tpu_torch")


def load_cases(filename: str, pkg: str) -> types.ModuleType:
    """``tests/<filename>`` compiled with ``tikv_tpu`` swapped for ``pkg``."""
    src = pathlib.Path(__file__).with_name(filename).read_text()
    src = src.replace("from tikv_tpu.", f"from {pkg}.").replace(
        "import tikv_tpu.", f"import {pkg}.")
    mod = types.ModuleType(f"{filename[:-3]}_{pkg}")
    exec(compile(src, f"{filename}[{pkg}]", "exec"), mod.__dict__)
    return mod


def case_names(mod: types.ModuleType, skip=()) -> list:
    return sorted(n for n in vars(mod)
                  if n.startswith("test_") and n not in skip)


def run_case(mod: types.ModuleType, name: str, monkeypatch) -> None:
    fn = getattr(mod, name)
    kw = {}
    for p in inspect.signature(fn).parameters:
        assert p == "monkeypatch", (name, p)
        kw[p] = monkeypatch
    fn(**kw)


CASES = {pkg: load_cases("test_raftstore.py", pkg) for pkg in PKGS}


def test_port_cases_run_the_port():
    mod = CASES["tikv_tpu_torch"]
    assert mod.Cluster.__module__ == "tikv_tpu_torch.testing.cluster"
    assert mod.Peer.__module__ == "tikv_tpu_torch.raftstore.metapb"


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("name", case_names(CASES["tikv_tpu"]))
def test_raftstore_case(pkg, name, monkeypatch):
    run_case(CASES[pkg], name, monkeypatch)


# ------------------------------------------------------------- parity


def mods(pkg: str) -> types.SimpleNamespace:
    imp = importlib.import_module
    return types.SimpleNamespace(
        pkg=pkg, cluster=imp(f"{pkg}.testing.cluster"),
        rs=imp(f"{pkg}.raftstore"), metapb=imp(f"{pkg}.raftstore.metapb"),
        failpoint=imp(f"{pkg}.utils.failpoint"))


def engine_cfs(engine) -> dict:
    out = {}
    for cf in ("default", "lock", "write", "raft"):
        it = engine.iterator_cf(cf, None, None)
        ok = it.seek_to_first()
        rows = []
        while ok:
            rows.append((it.key(), it.value()))
            ok = it.next()
        out[cf] = rows
    return out


def cluster_state(c) -> dict:
    """Everything the two packages must agree on, store by store."""
    stores = {}
    for sid in sorted(c.stores):
        store = c.stores[sid]
        peers = {}
        for rid in sorted(store.peers):
            p = store.peers[rid]
            r = p.region
            peers[rid] = (r.start_key, r.end_key, r.epoch.conf_ver,
                          r.epoch.version,
                          tuple((x.id, x.store_id, x.is_learner)
                                for x in r.peers),
                          p.meta.id, p.node.term, p.node.commit,
                          p.node.applied, p.applied_engine,
                          p.data_index_engine, p.merging,
                          p.consistency_state)
        stores[sid] = {"peers": peers, "cfs": engine_cfs(c.engines[sid])}
    regions = sorted({rid for s in c.stores.values() for rid in s.peers})
    return {"stores": stores,
            "leaders": {rid: c.leader_store(rid) for rid in regions}}


def both(drive):
    """``drive(mods)`` for each package → (reference's, port's)."""
    return tuple(drive(mods(pkg)) for pkg in PKGS)


def propose(c, peer, cmd):
    box: dict = {}
    peer.propose(cmd, lambda r: box.__setitem__("r", r))
    c._drive_until(lambda: "r" in box)
    if isinstance(box["r"], Exception):
        raise box["r"]
    return box["r"]


def compact(m, c, region_id: int) -> None:
    lead = c.leader_peer(region_id)
    propose(c, lead, m.rs.RaftCmd(region_id, lead.region.epoch,
                                  admin=m.rs.AdminCmd(
                                      "compact_log",
                                      compact_index=lead.node.commit)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_cluster_matches_the_reference(seed):
    """Writes, a transaction at fixed timestamps, a split, a leader
    transfer, a partition with log compaction and snapshot catch-up, a
    new peer by snapshot, a removed peer, and a consistency round per
    region: the same state after every step."""
    def drive(m):
        rng = random.Random(seed)
        c = m.cluster.Cluster(4, seed=seed)
        peers = tuple(m.rs.Peer(100 + sid, sid) for sid in (1, 2, 3))
        region = m.rs.Region(1, b"", b"", m.rs.RegionEpoch(1, 1), peers)
        for sid in (1, 2, 3):
            c.stores[sid].bootstrap_region(region)
        c.pd.bootstrap_cluster(m.metapb.Store(1), region)
        c.elect_leader(1, 1)
        states = []
        keys = [b"k%03d" % i for i in range(40)]
        for k in rng.sample(keys, 25):
            c.must_put(k, rng.randbytes(rng.choice((4, 40))))
        c.txn_write([("put", b"acct%d" % i, b"%d" % (100 * i))
                     for i in range(6)], start_ts=1000, commit_ts=1001)
        states.append(cluster_state(c))
        right = c.split_region(1, b"k020")
        c.pump()
        states.append(cluster_state(c))
        c.transfer_leader(right.id, 2)
        for k in rng.sample(keys, 10):
            c.must_put(k, b"after-" + k)
        states.append(cluster_state(c))
        filt = c.isolate_store(3)
        for k in rng.sample(keys, 12):
            c.must_put(k, b"lagged-" + k)
        compact(m, c, 1)
        compact(m, c, right.id)
        c.heal(filt)
        c.tick_all(8)
        states.append(cluster_state(c))
        c.change_peer(1, "add", m.rs.Peer(c.pd.alloc_id(), 4))
        c.tick_all(8)
        states.append(cluster_state(c))
        c.change_peer(right.id, "remove",
                      c.stores[3].region_peer(right.id).meta)
        c.pump()
        states.append(cluster_state(c))
        digests = [c.check_consistency(rid) for rid in (1, right.id)]
        states.append(cluster_state(c))
        pd = [(r.id, r.start_key, r.end_key) for r in
              (c.pd.get_region(b"a"), c.pd.get_region(b"k030"))]
        return states, digests, pd
    ref, port = both(drive)
    for i, (r, p) in enumerate(zip(ref[0], port[0])):
        assert p == r, f"step {i}"
    assert port[1:] == ref[1:]
    assert len(set(port[1])) == 2


def test_follower_read_and_lease_across_transfer_match():
    """A follower read by read index waits for its apply; the lease moves
    with the leader; both packages take the same paths (counters) and see
    the same values."""
    def drive(m):
        kv_engine = importlib.import_module(f"{m.pkg}.kv.engine")
        c = m.cluster.Cluster(3)
        c.bootstrap()
        c.start()
        c.must_put(b"k", b"v1")
        c.tick_all(4)
        out = []
        follower = next(s for s in c.stores if s != c.leader_store(1))
        c.transport.filters.append(lambda frm, to, rid, msg:
                                   to != follower)
        c.must_put(b"k", b"v2")
        c.transport.filters.clear()
        box: dict = {}
        c.stores[follower].peers[1].replica_read(
            lambda r: box.__setitem__("r", r))
        c._drive_until(lambda: "r" in box)
        out.append((box["r"].get_value(b"k"), box["r"].apply_index))
        c.transfer_leader(1, follower)
        c.tick_all(4)
        snap = c.kvs[follower].snapshot(kv_engine.SnapContext(region_id=1))
        out.append((snap.get_value(b"k"), c.kvs[follower].lease_reads,
                    c.kvs[follower].barrier_reads))
        return out, cluster_state(c)
    ref, port = both(drive)
    assert port == ref
    assert port[0][0][0] == b"v2"
