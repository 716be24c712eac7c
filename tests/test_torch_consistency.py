"""Consistency checking in the port, against the JAX package's: raft
ComputeHash / VerifyHash across replicas, and the MVCC cross-CF scan of
``storage/mvcc/consistency.py``.

``tests/test_consistency_check.py``'s cases run against both packages
(its source compiled a second time with the package name swapped), a
corrupted replica raising ``InconsistentRegion`` in both.  Then: the same
digests, round by round, over the same writes, splits and a pinned GC
safe point, with every replica's recorded state the reference's; and the
MVCC scan's list of problems equal to the reference's over the same
seeded corruptions of the same committed data.
"""

from __future__ import annotations

import importlib
import random

import pytest

from tests.test_torch_cluster import (
    PKGS,
    both,
    case_names,
    cluster_state,
    load_cases,
    run_case,
)

CASES = {pkg: load_cases("test_consistency_check.py", pkg) for pkg in PKGS}


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("name", case_names(CASES["tikv_tpu"]))
def test_consistency_case(pkg, name, monkeypatch):
    run_case(CASES[pkg], name, monkeypatch)


def test_corrupted_replica_raises_in_both():
    def drive(m):
        ps = importlib.import_module(f"{m.pkg}.raftstore.peer_storage")
        c = m.cluster.Cluster(3)
        c.bootstrap()
        c.start()
        for i in range(10):
            c.must_put(b"k%03d" % i, b"v%d" % i)
        good = c.check_consistency(1)
        victim = next(s for s in c.stores if s != c.leader_store(1))
        wb = c.engines[victim].write_batch()
        wb.put_cf("default", ps.data_key(b"k003x"), b"bitrot")
        c.engines[victim].write(wb)
        with pytest.raises(m.metapb.InconsistentRegion) as ei:
            c.check_consistency(1)
        return good, str(ei.value), victim
    ref, port = both(drive)
    assert port == ref


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hash_rounds_match_the_reference(seed):
    def drive(m):
        rng = random.Random(seed)
        c = m.cluster.Cluster(3, seed=seed)
        c.bootstrap()
        c.start()
        rounds = []
        ts = 100
        for step in range(4):
            for _ in range(6):
                c.txn_write([("put", b"h%03d" % rng.randrange(50),
                              rng.randbytes(rng.choice((6, 260))))],
                            start_ts=ts, commit_ts=ts + 1)
                ts += 2
            if step == 1:
                c.split_region(1, b"xh025")
                c.pump()
            if step == 2:
                # replicas hash only versions above the pinned safe point
                c.pd.set_gc_safe_point(ts - 6)
            rids = sorted(c.stores[1].peers)
            rounds.append([c.check_consistency(rid) for rid in rids])
        return rounds, cluster_state(c)
    ref, port = both(drive)
    assert port == ref


def test_mvcc_scan_problems_match_the_reference():
    def drive(m):
        pkg = m.pkg
        storage = importlib.import_module(f"{pkg}.storage")
        cmds = importlib.import_module(f"{pkg}.storage.txn.commands")
        kv = importlib.import_module(f"{pkg}.kv.engine")
        tt = importlib.import_module(f"{pkg}.storage.txn_types")
        mc = importlib.import_module(f"{pkg}.storage.mvcc.consistency")
        rng = random.Random(7)
        s = storage.Storage()
        ts = 10
        for _ in range(30):
            keys = rng.sample([b"m%02d" % i for i in range(20)], 2)
            s.sched_txn_command(cmds.Prewrite(
                [cmds.Mutation("put", k, rng.randbytes(
                    rng.choice((5, 300)))) for k in keys], keys[0], ts))
            s.sched_txn_command(cmds.Commit(keys, ts, ts + 1))
            ts += 2
        s.sched_txn_command(cmds.Prewrite(
            [cmds.Mutation("put", b"m05", b"Z" * 300)], b"m05", ts))
        bad = []
        for i in range(6):
            k = tt.encode_key(b"m%02d" % rng.randrange(20))
            kind = rng.choice(("orphan", "inverted", "drop"))
            if kind == "orphan":
                bad.append(("put", "default", tt.append_ts(k, 5 + i),
                            b"junk"))
            elif kind == "inverted":
                w = tt.Write(tt.WriteType.PUT, start_ts=900 + i,
                             short_value=b"x")
                bad.append(("put", "write", tt.append_ts(k, 800 + i),
                            w.to_bytes()))
            else:
                bad.append(("del", "default", tt.append_ts(k, 10 + 2 * i),
                            None))
        s.engine.write(kv.SnapContext(), kv.WriteData(bad))
        snap = s.engine.snapshot(kv.SnapContext())
        problems = mc.check_mvcc_consistency(snap)
        with pytest.raises(mc.MvccInconsistency):
            mc.check_mvcc_consistency(snap, raise_on_problem=True)
        return problems
    ref, port = both(drive)
    assert port == ref and port
