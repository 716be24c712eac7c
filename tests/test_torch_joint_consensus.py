"""Joint consensus (ConfChangeV2) in the port's raft and cluster, against
the JAX package's.

``tests/test_joint_consensus.py``'s cases run against both packages (its
source compiled a second time with the package name swapped): both
majorities for a commit and for an election, a two-replica swap in one
admin operation, and a change surviving the leader's restart mid-joint.
A seeded scenario then requires the same cluster state as the reference
at each step of a joint change: entering, leaving, a restart while joint,
and the new replicas catching up by snapshot.
"""

from __future__ import annotations

import pytest

from tests.test_torch_cluster import (
    PKGS,
    both,
    case_names,
    cluster_state,
    load_cases,
    run_case,
)

CASES = {pkg: load_cases("test_joint_consensus.py", pkg) for pkg in PKGS}


def test_port_cases_run_the_port():
    mod = CASES["tikv_tpu_torch"]
    assert mod.RawNode.__module__ == "tikv_tpu_torch.raft.raw_node"
    assert mod.Cluster.__module__ == "tikv_tpu_torch.testing.cluster"


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("name", case_names(CASES["tikv_tpu"]))
def test_joint_consensus_case(pkg, name, monkeypatch):
    run_case(CASES[pkg], name, monkeypatch)


@pytest.mark.parametrize("seed", [0, 3])
def test_joint_change_matches_the_reference(seed):
    def drive(m):
        rs = m.rs
        c = m.cluster.Cluster(5, seed=seed)
        peers = tuple(rs.Peer(100 + sid, sid) for sid in (1, 2, 3))
        region = rs.Region(1, b"", b"", rs.RegionEpoch(1, 1), peers)
        for sid in (1, 2, 3):
            c.stores[sid].bootstrap_region(region)
        c.pd.bootstrap_cluster(c.pd.get_store(1), region)
        c.elect_leader(1, 1)
        for i in range(12):
            c.must_put(b"j%02d" % i, b"v%d" % (i * seed))
        states = [cluster_state(c)]
        c.change_peers_joint(1, [
            ("add", rs.Peer(204, 4)), ("add", rs.Peer(205, 5)),
            ("remove", rs.Peer(102, 2)), ("remove", rs.Peer(103, 3))])
        c.pump()
        c.tick_all(5)
        states.append(cluster_state(c))
        c._drive_until(lambda: c.get_on_store(5, b"j11") is not None)
        c.must_put(b"after", b"joint")
        states.append(cluster_state(c))
        # a second change: enter, then every store restarts while joint
        lead = c.leader_peer(1)
        cmd_mod = __import__(f"{m.pkg}.raftstore.cmd",
                             fromlist=["encode_change_peer_v2"])
        box: dict = {}
        lead.propose(rs.RaftCmd(1, lead.region.epoch, admin=rs.AdminCmd(
            "change_peer_v2", extra=cmd_mod.encode_change_peer_v2(
                [("add", rs.Peer(302, 2))]))),
            lambda r: box.__setitem__("r", r))
        c._drive_until(lambda: "r" in box)
        for sid in list(c.stores):
            c.restart_store(sid)
        c.pump()
        c.elect_leader(1, 1)
        c.pump()

        def settled():
            lp = c.leader_peer(1)
            return lp is not None and not lp.node.in_joint() and \
                any(p.store_id == 2 for p in lp.region.peers)
        c._drive_until(settled)
        c.tick_all(5)
        states.append(cluster_state(c))
        return states
    ref, port = both(drive)
    for i, (r, p) in enumerate(zip(ref, port)):
        assert p == r, f"step {i}"
    final = port[-1]["stores"][1]["peers"][1]
    assert sorted(x[1] for x in final[4]) == [1, 2, 4, 5]
