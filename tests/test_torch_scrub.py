"""The port's scrub (``DeviceStateSupervisor.scrub``, its thread, and the
runner's quarantine gate) against the reference's
(``tikv_tpu/device/supervisor.py:1354-1511``, ``runner.py:1941-1975``).

Both packages serve the same writes (``test_torch_write_churn.Churn``):
a pass after the patches is clean on both; ``device::feed_corrupt`` flips a
bit and the pass reports one divergence and the quarantined region on both;
the next request is answered on the host (the port's endpoint counts a
``quarantined`` degrade and reports backend ``host``; the reference's
runner labels it ``quarantined``), the one after uploads on the device; a
bounded pass rotates its cursor as the reference's does; the thread starts
and stops; the port hashes under the dispatch lock on one device as on a
mesh (its patch writes the resident planes in place), so a patch that
comes during a pass waits for it and never reads as a divergence.
"""

from __future__ import annotations

import threading
import time

import pytest

import jax

from tikv_tpu.device.runner import DeviceRunner as RefRunner
from tikv_tpu.parallel import make_mesh as ref_make_mesh
from tikv_tpu.utils import failpoint as ref_failpoint

from tikv_tpu_torch.device.runner import DeviceRunner
from tikv_tpu_torch.parallel import make_mesh
from tikv_tpu_torch.utils import failpoint

from tests.test_torch_write_churn import WRITES, Churn, base


@pytest.fixture(scope="module")
def ref_runner():
    return RefRunner(mesh=ref_make_mesh(jax.devices()[:1]))


@pytest.fixture(autouse=True)
def _teardown_failpoints():
    yield
    failpoint.teardown()
    ref_failpoint.teardown()


def warm_and_patch(rig: Churn) -> None:
    base(rig)
    for plan in ("agg", "sel"):
        rig.serve(plan)
    for w in ("one update", "four runs", "appends"):
        WRITES[w](rig)
        for plan in ("agg", "sel"):
            assert rig.serve(plan)["labels"]["device_feed"] == "patch"


def same_pass(p: dict, r: dict) -> None:
    assert {k: p[k] for k in ("lines", "planes", "divergences",
                              "quarantined_regions")} == \
        {k: r[k] for k in ("lines", "planes", "divergences",
                           "quarantined_regions")}


def test_clean_pass_after_patches(ref_runner):
    rig = Churn(ref_runner)
    warm_and_patch(rig)
    p, r = rig.psup.scrub(), rig.rsup.scrub()
    same_pass(p, r)
    assert p["divergences"] == 0 and p["lines"] == 1 and p["planes"] == 7
    st = rig.psup.stats()
    assert (st["scrub_passes"], st["scrub_divergences"],
            st["quarantines"]) == (1, 0, 0)
    assert st["last_scrub"]["planes"] == 7


def test_corruption_is_caught_then_served_on_the_host(ref_runner):
    rig = Churn(ref_runner)
    warm_and_patch(rig)
    failpoint.cfg("device::feed_corrupt", "1*return")
    ref_failpoint.cfg("device::feed_corrupt", "1*return")
    p, r = rig.psup.scrub(), rig.rsup.scrub()
    same_pass(p, r)
    assert p["divergences"] == 1 and p["quarantined_regions"] == [1]
    assert rig.prunner.hbm_stats()["quarantined"] == 1
    assert rig.prunner.hbm_stats()["resident_lines"] == 0
    assert rig.psup.stats()["quarantines"] == rig.rsup.quarantines == 1
    # the next request: the host, counted as a degrade
    got = rig.serve("sel")
    assert got["backend"] == "host"
    assert got["labels"]["device_feed"] == "quarantined"
    assert got["ref_labels"]["device_feed"] == "quarantined"
    assert rig.pep.degrades == {"quarantined": 1}
    assert rig.prunner.hbm_stats()["quarantined"] == 0
    # the one after: the device, a fresh upload from host truth
    got = rig.serve("sel")
    assert got["backend"] == "device"
    assert got["labels"]["device_feed"] == "upload"
    assert got["ref_labels"]["device_feed"] == "upload"
    p, r = rig.psup.scrub(), rig.rsup.scrub()
    same_pass(p, r)
    assert p["divergences"] == 0


def test_forced_device_request_raises_the_quarantine(ref_runner):
    """A request that forced the device surfaces the quarantine instead of
    a host answer; the quarantine is spent either way."""
    from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest
    from tikv_tpu_torch.device import FeedQuarantined
    from tests.test_torch_write_churn import plans
    rig = Churn(ref_runner, ref=False)
    warm_and_patch(rig)
    failpoint.cfg("device::feed_corrupt", "1*return")
    assert rig.psup.scrub()["divergences"] == 1
    pd, _rd = plans("agg", rig.ts + 5)
    with pytest.raises(FeedQuarantined):
        rig.pep.handle(CopRequest(REQ_TYPE_DAG, pd, force_backend="device"))
    assert rig.serve("agg", ref=False)["backend"] == "device"


def second_line(rig: Churn, ts=None):
    """A request over another column set: a second cache line (anchor)."""
    from tikv_tpu_torch.copr.endpoint import REQ_TYPE_DAG, CopRequest
    from tikv_tpu_torch.testing.dag import DagSelect
    from tikv_tpu.copr.endpoint import CopRequest as RefRequest
    from tikv_tpu.testing.dag import DagSelect as RefDagSelect
    from tikv_tpu.testing.fixture import int_table as ref_int_table
    from tests.test_torch_region_cache import TID, port_table
    ts = rig.ts + 5 if ts is None else ts
    s = DagSelect.from_table(port_table(), ["id", "c1"])
    rs = RefDagSelect.from_table(ref_int_table(2, table_id=TID),
                                 ["id", "c1"])
    rig.pep.handle(CopRequest(REQ_TYPE_DAG,
                              s.where(s.col("c1") > 995).build(ts)))
    rig.rep.handle(RefRequest(REQ_TYPE_DAG,
                              rs.where(rs.col("c1") > 995).build(ts)))


def test_bounded_pass_rotates_its_cursor(ref_runner, monkeypatch):
    rig = Churn(ref_runner)
    warm_and_patch(rig)
    second_line(rig)
    items = rig.prunner.arena_items()
    assert len(items) == 2
    owner = {v["flat"][0].data_ptr(): i for i, (_a, b) in enumerate(items)
             for v in b.values() if isinstance(v, dict) and "flat" in v}
    seen = []
    real = rig.prunner.scrub_feed

    def spy(feed):
        seen.append(owner[feed["flat"][0].data_ptr()])
        return real(feed)

    monkeypatch.setattr(rig.prunner, "scrub_feed", spy)
    visits = []
    for _ in range(3):
        del seen[:]
        p, r = rig.psup.scrub(max_lines=1), rig.rsup.scrub(max_lines=1)
        same_pass(p, r)
        assert p["lines"] == 1 and len(set(seen)) == 1
        visits.append(seen[0])
        assert rig.psup._scrub_cursor == rig.rsup._scrub_cursor
    # the two lines in turn
    assert visits in ([0, 1, 0], [1, 0, 1]), visits
    sup = rig.psup
    sup._scrub_max_lines = 1
    assert sup.scrub()["lines"] == 1


def test_scrub_thread_starts_and_stops(ref_runner):
    from tikv_tpu_torch.device.supervisor import DeviceStateSupervisor
    rig = Churn(ref_runner, ref=False)
    warm_and_patch(rig)
    sup = DeviceStateSupervisor(rig.prunner, rig.pc, rig.psink,
                                scrub_interval=0.01)
    sup.start()
    try:
        t0 = time.monotonic()
        while sup.stats()["scrub_passes"] < 2:
            assert time.monotonic() - t0 < 30, "the scrub thread is stuck"
            time.sleep(0.01)
        assert sup._thread is not None and sup._thread.is_alive()
    finally:
        sup.stop()
    assert sup._thread is None
    passes = sup.stats()["scrub_passes"]
    time.sleep(0.05)
    assert sup.stats()["scrub_passes"] == passes
    assert sup.stats()["scrub_divergences"] == 0
    idle = DeviceStateSupervisor(rig.prunner, rig.pc)
    idle.start()
    assert idle._thread is None         # no interval: no thread


@pytest.mark.parametrize("mesh", [False, True])
def test_hashing_holds_the_dispatch_lock(monkeypatch, mesh):
    runner = DeviceRunner(mesh=make_mesh(["cpu"] * 4), chunk_rows=512) \
        if mesh else DeviceRunner(device="cpu")
    rig = Churn(None, runner, ref=False)
    base(rig)
    rig.serve("agg", ref=False)
    held = []
    real = runner.scrub_feed

    def spy(feed):
        held.append(runner._dispatch_mu._is_owned())
        return real(feed)

    monkeypatch.setattr(runner, "scrub_feed", spy)
    assert rig.psup.scrub()["divergences"] == 0
    assert held == [True]
    failpoint.cfg("device::feed_corrupt", "1*return")
    out = rig.psup.scrub()
    assert held[-1] is True
    assert out["divergences"] == 1 and out["quarantined_regions"] == [1]
    got = rig.serve("agg", ref=False)
    assert got["backend"] == "host" and rig.pep.degrades == {
        "quarantined": 1}
    got = rig.serve("agg", ref=False)
    assert got["backend"] == "device"
    assert got["labels"]["device_feed"] == "upload"
    assert rig.psup.scrub()["divergences"] == 0


def test_a_patch_during_a_pass_waits_and_is_no_divergence(monkeypatch):
    """A request that patches the feed in place while a pass is about to
    hash it: the patch waits for the pass (the dispatch lock), so the pass
    hashes the planes its record describes, finds no divergence, and
    quarantines nothing; the request is then served by a patch."""
    rig = Churn(None, ref=False)
    base(rig)
    rig.serve("agg", ref=False)
    WRITES["one update"](rig)
    served, waited, threads = {}, [], []
    real = rig.prunner.scrub_feed

    def patch_then_hash(feed):
        t = threading.Thread(target=lambda: served.update(
            rig.serve("agg", ref=False)), daemon=True)
        threads.append(t)
        t.start()
        t.join(0.5)             # time enough for the patch, had it run
        waited.append(t.is_alive())
        return real(feed)

    monkeypatch.setattr(rig.prunner, "scrub_feed", patch_then_hash)
    out = rig.psup.scrub()
    threads[0].join(30)
    assert not threads[0].is_alive()
    assert waited == [True]
    assert out["divergences"] == 0 and out["quarantined_regions"] == []
    assert rig.prunner.hbm_stats()["quarantined"] == 0
    assert served["labels"]["device_feed"] == "patch"
    monkeypatch.setattr(rig.prunner, "scrub_feed", real)
    assert rig.psup.scrub()["divergences"] == 0


def test_destroyed_peer_drops_its_delta_log(ref_runner):
    rig = Churn(ref_runner, ref=False)
    base(rig)
    rig.serve("agg", ref=False)
    assert rig.psink.depth(1) == 1
    rig.phost.notify_peer_destroyed(1)
    assert rig.psink.stats()["regions"] == 0
    assert rig.pc.stats()["resident_lines"] == 0
    rig.phost.notify_data_replaced(1, rig.index + 1)
    assert rig.psup.stats()["lifecycle_invalidations"] == 1
