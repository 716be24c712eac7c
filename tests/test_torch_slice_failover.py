"""Slice failure domains of a placement mesh: the port against the JAX
package.

The port (``DeviceRunner(mesh=make_mesh(["cpu"] * 4), placement=True)``,
the plain version of every kernel) and the reference (``DeviceRunner(mesh=
make_mesh(jax.devices()[:4]), placement=True)``) take the same snapshots,
requests and ``device::slice_dead`` faults: a named slice fails its
dispatches (answered by the host pipeline) until it trips, its anchors
drain to healthy slices by migration, a quarantined slice refuses dispatch,
a half-open canary re-admits it with a decayed score, a whole-mesh region
runs on the largest healthy submesh (or on the host when that rebuild
fails), a deferred request whose slice dies before its fetch is rescued
once, and with every slice dead requests are answered on the host without
pins churning.  Every answer is held exactly against the reference's and
the host pipeline's (sorted rows); the whole-mesh region's also against
the reference's single-device runner.
"""

import threading
import time

import jax
import pytest

from tikv_tpu.device.runner import DeviceRunner as RefRunner
from tikv_tpu.executors.runner import BatchExecutorsRunner
from tikv_tpu.parallel import make_mesh as ref_make_mesh
from tikv_tpu.utils import failpoint as ref_failpoint

from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest, Endpoint
from tikv_tpu_torch.device import DEVICE_FAULTS, DeviceUnavailable
from tikv_tpu_torch.utils import failpoint, tracker

from tests.test_torch_placement import (STATE_KEYS, WHOLE_ROWS, agg_dag,
                                        make_snap, make_table, port_runner,
                                        ref_runner, rows, sel_dag, slice_of)
from tests.test_torch_selection import port_dag, port_snapshot


@pytest.fixture(autouse=True)
def _teardown_failpoints():
    yield
    failpoint.teardown()
    ref_failpoint.teardown()


@pytest.fixture(scope="module")
def single():
    return RefRunner(mesh=ref_make_mesh(jax.devices()[:1]))


def arm(value: str, *names) -> None:
    """Arm the failpoints ``names`` (default ``device::slice_dead``) with
    ``value`` on both packages."""
    for name in names or ("device::slice_dead",):
        failpoint.cfg(name, value)
        ref_failpoint.cfg(name, value)


def heal(*runners, deadline_s: float = 3.0) -> None:
    """Disarm, and probe until every slice is re-admitted and the whole
    mesh restored."""
    failpoint.teardown()
    ref_failpoint.teardown()
    for r in runners:
        end = time.monotonic() + deadline_s
        while r._board.quarantined_set() and time.monotonic() < end:
            r.probe_quarantined()
            time.sleep(0.02)
        assert not r._board.quarantined_set(), r._board.stats()
        r._degraded_target()


class Rig:
    """Both placement runners over the same snapshots and requests."""

    def __init__(self, tid: int, sizes, seed: int = 0, **runner_kw):
        self.ref, self.port = ref_runner(**runner_kw), \
            port_runner(**runner_kw)
        table = make_table(tid)
        self.snaps = [make_snap(table, n, seed + i,
                                null_frac=0.1 if i % 3 == 0 else 0.0)
                      for i, n in enumerate(sizes)]
        self.psnaps = [port_snapshot(table, s) for s in self.snaps]
        self.dag = agg_dag(table)
        self.pdag = port_dag(self.dag)
        self.sels = [sel_dag(table, t) for t in (-20_000, 20_000)]
        self.hosts = [rows(BatchExecutorsRunner(self.dag, s)
                           .handle_request()) for s in self.snaps]

    def serve(self, i: int, deferred: bool = False):
        """Request i on both runners → the port's answer or handle."""
        want = rows(self.ref.handle_request(self.dag, self.snaps[i]))
        assert want == self.hosts[i], i
        got = self.port.handle_request(self.pdag, self.psnaps[i],
                                       deferred=deferred)
        if not deferred:
            assert rows(got) == want, i
        return got

    def serve_all(self) -> None:
        for i in range(len(self.snaps)):
            self.serve(i)

    def close(self) -> None:
        heal(self.ref, self.port)
        self.ref.close()
        self.port.close()


def test_dead_slice_trips_drains_by_migration_and_refuses_dispatch():
    rig = Rig(6101, [1500] * 8)
    rig.serve_all()
    port, ref = rig.port, rig.ref
    victim = slice_of(port, rig.psnaps[0])
    assert victim == slice_of(ref, rig.snaps[0])
    arm(f"return({victim})")
    try:
        for _ in range(4):
            rig.serve_all()
        for r in (ref, port):
            st = r.placer.stats()
            sl = st["slices"][victim]
            assert sl["quarantined"] and sl["placed_anchors"] == 0, st
            assert sl["resident_lines"] == 0 and st["drained"] >= 1, st
            assert st["migrations"] >= 1, "the drain did not migrate"
            health = r._board.slice(victim).stats()
            assert health["launched_quarantined"] == 0
        assert port.route_stats()["degrades"].get("slice_dead", 0) >= 1
        # warm serving while quarantined runs on the healthy slices
        before = port.route_stats()["degrades"]
        tr, tok = tracker.install()
        try:
            rig.serve_all()
        finally:
            tracker.uninstall(tok)
        assert port.route_stats()["degrades"] == before
        assert "d2h_wait" in tr.phases
        # a request that reaches the quarantined slice is refused
        owner = port.placer.slices[victim]
        assert rows(owner.handle_request(rig.pdag, rig.psnaps[0])) == \
            rig.hosts[0]
        assert port._board.slice(victim).stats()["refusals"] >= 1
        assert port._board.slice(victim).stats()["launched_quarantined"] \
            == 0
    finally:
        heal(ref, port)
    for r in (ref, port):
        st = r._board.slice(victim).stats()
        assert st["state"] == "healthy" and st["readmits"] >= 1
    rig.serve_all()
    rig.close()


def test_half_open_readmission_gives_a_decayed_score():
    rig = Rig(6102, [1200, 1300])
    rig.serve_all()
    idx = slice_of(rig.port, rig.psnaps[0])
    arm(f"return({idx})")
    try:
        for _ in range(3):
            rig.serve(0)
        for r in (rig.ref, rig.port):
            assert idx in r._board.quarantined_set()
        time.sleep(0.06)
        for r in (rig.ref, rig.port):
            r.probe_quarantined()       # the canary fails: still dead
            st = r._board.slice(idx).stats()
            assert st["probe_failures"] >= 1 and st["state"] == "quarantined"
    finally:
        failpoint.teardown()
        ref_failpoint.teardown()
    time.sleep(0.06)
    got = []
    for r in (rig.ref, rig.port):
        assert r.probe_quarantined() == 1
        st = r._board.slice(idx).stats()
        got.append({k: st[k] for k in ("state", "score", "readmits",
                                       "probe_failures", "trips")})
        assert r._board.penalty(idx) > 0.5
    assert got[0] == got[1]
    assert got[1]["state"] == "healthy" and got[1]["score"] == 2.0
    rig.close()


def test_whole_mesh_region_runs_on_the_degraded_submesh(single):
    rig = Rig(6103, [WHOLE_ROWS + 700])
    want = rows(single.handle_request(rig.dag, rig.snaps[0]))
    assert want == rig.hosts[0]
    rig.serve(0)
    port = rig.port
    arm("return(1)")
    try:
        for _ in range(3):      # the host rung, exact, until the trip
            rig.serve(0)
        assert port.route_stats()["degrades"] == {"slice_dead": 3}
        tr, tok = tracker.install()
        try:
            got = rows(port.handle_request(rig.pdag, rig.psnaps[0]))
        finally:
            tracker.uninstall(tok)
        assert got == want
        assert "mesh_rebuild" in tr.phases and "d2h_wait" in tr.phases
        assert port._degraded_sub()._slice_indices == (0, 2)
        for _ in range(3):
            rig.serve(0)
        assert port.device_health()["degraded"] == \
            rig.ref.failure_domain_stats()["degraded"] == \
            {"dead_slices": [1], "healthy_devices": 2}
        assert port.failure_events == {"mesh_downsize": 1}
        assert port.route_stats()["degrades"] == {"slice_dead": 3}
    finally:
        heal(rig.ref, port)
    assert "degraded" not in port.device_health()
    assert port.failure_events == {"mesh_downsize": 1, "mesh_restore": 1}
    rig.serve(0)
    rig.close()


def test_a_failed_rebuild_falls_to_the_host_rung():
    rig = Rig(6104, [WHOLE_ROWS + 300])
    rig.serve(0)
    port = rig.port
    arm("return(0)")
    arm("return", "device::mesh_rebuild")
    try:
        for _ in range(6):
            rig.serve(0)
        assert "degraded" not in port.device_health()
        assert port.route_stats()["degrades"] == {"slice_dead": 3,
                                                  "mesh_rebuild": 3}
        assert port._dispatch_mu.acquire(timeout=1)
        port._dispatch_mu.release()
        failpoint.remove("device::mesh_rebuild")
        ref_failpoint.remove("device::mesh_rebuild")
        rig.serve(0)
        assert port.device_health()["degraded"]["healthy_devices"] == 2
    finally:
        heal(rig.ref, port)
    rig.close()


def test_latency_outliers_strike_and_trip_as_the_reference():
    """``slice_latency_outlier_s`` below any fetch's time: each served
    fetch strikes its slice 0.25 instead of decaying its score, and at
    three strikes the slice trips and its anchors drain, step for step as
    on the reference's runner."""
    rig = Rig(6111, [2048, 1024], seed=100, slice_latency_outlier_s=1e-9)
    port, ref = rig.port, rig.ref
    rig.serve(1)
    rig.serve(0)
    idx = slice_of(port, rig.psnaps[0])
    for step in range(11):
        rig.serve(0)
        want = [{k: s[k] for k in STATE_KEYS} for s in ref._board.stats()]
        assert [{k: s[k] for k in STATE_KEYS}
                for s in port._board.stats()] == want, step
    assert port._board.quarantined_set() == frozenset({idx})
    assert port._board.slice(idx).strikes["latency"] >= 12
    assert slice_of(port, rig.psnaps[0]) != idx
    rig.serve_all()
    rig.close()


def test_a_deferred_request_whose_slice_dies_is_rescued_once():
    rig = Rig(6105, [2048, 1024], seed=40)
    rig.serve_all()
    port, ref = rig.port, rig.ref
    idx = slice_of(port, rig.psnaps[0])
    d = port.handle_request(rig.pdag, rig.psnaps[0], deferred=True)
    rd = ref.handle_request(rig.dag, rig.snaps[0], deferred=True)
    arm(f"return({idx})")
    try:
        assert rows(d.result()) == rows(rd.result()) == rig.hosts[0]
        assert d.rescued and d.degraded is None
        assert port.failure_events.get("rescue") == 1
        assert port.hbm_stats()["pinned_lines"] == 0
        owner = port.placer.slices[idx]
        assert owner._dispatch_mu.acquire(timeout=1)
        owner._dispatch_mu.release()
        assert rows(d.result()) == rig.hosts[0]     # memoized
        assert port.failure_events.get("rescue") == 1
        assert idx in port._board.quarantined_set()
        assert slice_of(port, rig.psnaps[0]) != idx
    finally:
        heal(ref, port)
    rig.close()


def test_a_rescue_the_host_answered_is_a_degrade():
    """The slice dies between its dispatch and its fetch (``1*off->``: the
    dispatch's check passes) and the retry's own fetch fails too: the
    endpoint counts a fetch degrade and reports the host backend."""
    rig = Rig(6109, [2048], seed=80)
    rig.serve_all()
    port, snap = rig.port, rig.psnaps[0]
    idx = slice_of(port, snap)
    ep = Endpoint(lambda req: snap, port, device_row_threshold=1)
    failpoint.cfg("device::slice_dead", f"1*off->return({idx})")
    failpoint.cfg("device::before_fetch", "2*return")
    try:
        tr, tok = tracker.install()
        try:
            resp = ep.handle(CopRequest(REQ_TYPE_DAG, rig.pdag))
        finally:
            tracker.uninstall(tok)
        assert sorted(resp.rows(), key=repr) == rig.hosts[0]
        assert resp.backend == "host" and ep.degrades == {"fetch": 1}
        assert tr.labels.get("device_rescue") == "slice_failover"
        assert port.failure_events.get("rescue") == 1
        assert idx in port._board.quarantined_set()
    finally:
        heal(rig.ref, port)
    rig.close()


def test_a_synchronous_fetch_fault_is_rescued_or_reaches_the_caller():
    """Without ``deferred``: a dead slice's fetch is served once more on a
    healthy slice; a fetch fault no card served raises to the caller."""
    rig = Rig(6110, [2048], seed=90)
    rig.serve_all()
    port, snap = rig.port, rig.psnaps[0]
    idx = slice_of(port, snap)
    failpoint.cfg("device::slice_dead", f"1*off->return({idx})")
    try:
        assert rows(port.handle_request(rig.pdag, snap)) == rig.hosts[0]
        assert port.failure_events.get("rescue") == 1
        assert slice_of(port, snap) != idx
    finally:
        heal(rig.ref, port)
    # a healthy slice's fetch fault: struck, not rescued
    idx = slice_of(port, snap)
    failpoint.cfg("device::before_fetch", "1*return")
    with pytest.raises(DeviceUnavailable):
        port.handle_request(rig.pdag, snap)
    assert port._board.slice(idx).strikes == {"fetch": 1}
    assert port.failure_events.get("rescue") == 1
    # a rescue whose own fetch fails: the first fault reaches the caller
    failpoint.cfg("device::slice_dead", f"1*off->return({idx})")
    failpoint.cfg("device::before_fetch", "2*return")
    try:
        with pytest.raises(DeviceUnavailable):
            port.handle_request(rig.pdag, snap)
        assert port.failure_events.get("rescue") == 2
    finally:
        heal(rig.ref, port)
    assert rows(port.handle_request(rig.pdag, snap)) == rig.hosts[0]
    rig.close()


def test_a_coalesced_group_whose_slice_dies_is_rescued_per_member():
    rig = Rig(6106, [4096], seed=60)
    port, snap = rig.port, rig.psnaps[0]
    d1, d2 = (port_dag(d) for d in rig.sels)
    hosts = [rows(BatchExecutorsRunner(d, rig.snaps[0]).handle_request())
             for d in rig.sels]
    k1, k2 = port.batch_class(d1, snap), port.batch_class(d2, snap)
    assert k1 is not None and k1[0] == "slice" and k1 == k2, (k1, k2)
    idx = slice_of(port, snap)
    group = port.handle_batched([(d1, snap), (d2, snap)])
    arm(f"return({idx})")
    try:
        assert rows(group.member_result(0)) == hosts[0]
        assert rows(group.member_result(1)) == hosts[1]
        assert port.failure_events.get("rescue") == 2
        assert port.hbm_stats()["pinned_lines"] == 0
    finally:
        heal(rig.ref, port)
    rig.close()


def test_every_slice_dead_serves_on_the_host_without_churn():
    rig = Rig(6107, [900, 1000, 1100, 1200, 1300, 1400], seed=20)
    rig.serve_all()
    port = rig.port
    arm("return")
    try:
        for _ in range(6):
            rig.serve_all()
        for r in (rig.ref, port):
            assert r._board.quarantined_set() == frozenset(range(4))
        pins = [slice_of(port, s) for s in rig.psnaps]
        st = port.placer.stats()
        tr, tok = tracker.install()
        try:
            for _ in range(3):
                rig.serve_all()
        finally:
            tracker.uninstall(tok)
        assert tr.labels.get("device_feed") == "slice_quarantined"
        assert [slice_of(port, s) for s in rig.psnaps] == pins
        after = port.placer.stats()
        for k in ("failovers", "places", "migrations", "drained"):
            assert after[k] == st[k], k
        assert all(s["launched_quarantined"] == 0
                   for s in port._board.stats())
    finally:
        heal(rig.ref, port)
    rig.serve_all()
    rig.close()


def test_dispatch_and_fetch_faults_never_wedge_the_locks():
    """Concurrent requests while a slice flaps (``50%return(i)``): every
    answer exact, every lock free afterwards.  A synchronous request whose
    fetch fault no healthy slice served raises it (its caller answers on
    the host); a deferred one never raises."""
    rig = Rig(6108, [800, 900, 1000, 1100], seed=70)
    rig.serve_all()
    port = rig.port
    failpoint.cfg("device::slice_dead", "50%return(0 1)")
    errors, results = [], {}

    def worker(w):
        try:
            for j in range(6):
                i = (w + j) % len(rig.psnaps)
                try:
                    d = port.handle_request(rig.pdag, rig.psnaps[i],
                                            deferred=bool(j % 2))
                except DEVICE_FAULTS:
                    if j % 2:
                        raise
                    results[(w, j)] = True      # the caller's host answer
                    continue
                got = d if not hasattr(d, "result") else d.result()
                results[(w, j)] = rows(got) == rig.hosts[i]
        except Exception as e:      # noqa: BLE001 — reported below
            errors.append(e)

    ts = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    failpoint.teardown()
    assert not errors and all(results.values()) and len(results) == 24
    for r in [port] + port.placer.slices:
        assert r._dispatch_mu.acquire(timeout=1)
        r._dispatch_mu.release()
    rig.close()
