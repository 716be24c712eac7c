"""The replica-feed state machine: the port's ``DeviceStateSupervisor``
``on_role_change`` / ``promote_region`` against the reference's.

Both packages' supervisors, caches and runners (the rig of
``tests/test_torch_write_churn.py``) take the same events: a demotion, a
read and a write while a follower, a promotion (a digest re-verify of every
resident plane, no build), a demotion with a plane corrupted then a
promotion (the anchor quarantined, the region's lines invalidated, the
next request rebuilds), and a promotion with ``copr::replica_promote``
armed.  After each step the counters (``promotions``,
``promotion_rebuilds``, ``demotions``, ``quarantines``, the cache's
invalidations and resident lines) equal the reference's, and the answers
equal the numpy model of the rows and the reference's.
"""

from __future__ import annotations

import pytest

import jax

from tikv_tpu.device.runner import DeviceRunner as RefRunner
from tikv_tpu.parallel import make_mesh as ref_make_mesh
from tikv_tpu.utils import failpoint as ref_failpoint

from tikv_tpu_torch.device import runner as rmod
from tikv_tpu_torch.utils import failpoint

from tests.test_torch_write_churn import Churn, base


@pytest.fixture(scope="module")
def ref_runner():
    return RefRunner(mesh=ref_make_mesh(jax.devices()[:1]))


def counters(rig: Churn) -> tuple:
    """(port's, reference's) counters of the state machine and the cache."""
    out = []
    for sup, cache in ((rig.psup, rig.pc), (rig.rsup, rig.rc)):
        out.append((sup.promotions, sup.promotion_rebuilds, sup.demotions,
                    sup.quarantines, cache.invalidations,
                    cache.region_resident(1)))
    return tuple(out)


def both(rig: Churn, event: str, *args) -> None:
    getattr(rig.psup, event)(*args)
    getattr(rig.rsup, event)(*args)


def same(rig: Churn, want: tuple) -> None:
    p, r = counters(rig)
    assert p == r == want, (p, r)


def test_role_changes_match_the_reference(ref_runner, monkeypatch):
    digests = []
    real = rmod.plane_digest

    def counted(arr, lo, n):
        digests.append(n)
        return real(arr, lo, n)

    monkeypatch.setattr(rmod, "plane_digest", counted)
    rig = Churn(ref_runner)
    base(rig)
    for plan in ("agg", "sel"):
        assert rig.serve(plan)["labels"]["device_feed"] == "upload"
    same(rig, (0, 0, 0, 0, 0, 1))
    # a leader loss keeps the lines: the next reads hit the resident feeds
    both(rig, "on_role_change", 1, False)
    same(rig, (0, 0, 1, 0, 0, 1))
    assert rig.psup.stats()["replica_feeds"] == 1
    for plan in ("agg", "sel"):
        got = rig.serve(plan)
        assert got["labels"]["device_feed"] == "hit"
        assert got["ref_labels"]["device_feed"] == "hit"
    # a follower's apply patches them
    rig.put_rows({7: (3, 995)})
    for plan in ("agg", "sel"):
        got = rig.serve(plan)
        assert got["labels"]["device_feed"] == "patch"
    # the leader gain: every resident plane re-hashed, nothing built
    planes = sum(len(f["digests"]) for f in rig.prunner.resident_feeds(
        rig.get()[0]).values())
    assert planes == 7     # agg: c0, c1 and its validity; sel: 4
    digests.clear()
    both(rig, "on_role_change", 1, True)
    same(rig, (1, 0, 1, 0, 0, 1))
    assert len(digests) == planes
    assert rig.psup.last_promotion["planes"] == planes
    assert rig.psup.last_promotion["divergences"] == 0
    assert rig.psup.stats()["replica_feeds"] == 0
    for plan in ("agg", "sel"):
        got = rig.serve(plan)
        assert got["labels"]["device_feed"] == "hit"
        assert "columnar_build" not in got["phases"]
    # a corrupted plane: the promotion quarantines and invalidates
    both(rig, "on_role_change", 1, False)
    pfeed, rfeed, _pent = rig.feed("agg")
    rig.prunner.corrupt_resident_plane(pfeed)
    ref_runner.corrupt_resident_plane(rfeed)
    both(rig, "on_role_change", 1, True)
    same(rig, (2, 1, 2, 1, 1, 0))
    assert rig.psup.last_promotion["quarantined_regions"] == [1]
    misses = rig.pc.misses
    for plan in ("agg", "sel"):
        got = rig.serve(plan)
        assert got["backend"] == "device"
    assert rig.pc.misses == misses + 1 == rig.rc.misses
    same(rig, (2, 1, 2, 1, 1, 1))
    # the failpoint: a promotion that rebuilds without a verify
    both(rig, "on_role_change", 1, False)
    failpoint.cfg("copr::replica_promote", "1*return")
    ref_failpoint.cfg("copr::replica_promote", "1*return")
    try:
        digests.clear()
        both(rig, "on_role_change", 1, True)
    finally:
        failpoint.teardown()
        ref_failpoint.teardown()
    assert digests == []
    same(rig, (3, 2, 3, 1, 2, 0))
    for plan in ("agg", "sel"):
        got = rig.serve(plan)
        assert got["backend"] == "device"
        assert got["labels"]["device_feed"] == "upload"
    assert rig.pc.misses == misses + 2 == rig.rc.misses


def test_promotion_without_a_replica_feed(ref_runner):
    """A leader gain over nothing resident verifies nothing; over lines
    still resident (no demotion seen) it promotes them."""
    rig = Churn(ref_runner)
    base(rig)
    both(rig, "on_role_change", 1, True)
    same(rig, (0, 0, 0, 0, 0, 0))
    rig.serve("agg")
    both(rig, "on_role_change", 1, True)
    same(rig, (1, 0, 0, 0, 0, 1))
    both(rig, "note_replica_feed", 1)
    assert rig.psup.stats()["replica_feeds"] == 1
    both(rig, "on_role_change", 1, True)
    same(rig, (2, 0, 0, 0, 0, 1))
